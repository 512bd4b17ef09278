"""Sharded stereo pipeline: shard_map'd cost, SGM, and reduction.

Partitioning (SURVEY.md §7): the [H, W, D] cost volume is sharded over image
rows (H) along the ``tile`` mesh axis and over frames along ``batch``; W and
D stay whole per device (D is the axis every recurrence reduces over).

What crosses tile boundaries, and how:

* SSD's row window — k-row halos of both input images pulled from neighbors
  (``halo.pad_with_halos``), then the window sum consumes them locally.
  Birchfield's window is scanline-local (W only): no exchange at all.
* Horizontal SGM sweeps and the DP reducer scan along W with rows
  vectorized — row sharding is orthogonal, fully parallel, zero comms.
* Vertical and diagonal SGM sweeps scan along H, crossing every tile
  boundary.  Two strategies:
  - ``exact``:   sequential chunked scan with carry hand-off.  Tile p's
    sweep starts from tile p-1's final carry, one [W, D] vector + one [W]
    intensity row ppermuted per boundary.  Wall-clock for these sweeps
    equals the unsplit scan (it is a dependency chain), so they pipeline
    across the 6 scan-crossing sweeps while the rest of the pipeline
    scales linearly.  Bit-exact vs the single-chip kernels.
  - ``overlap``: warm-up halo scan.  Each tile pulls ``overlap`` extra rows
    preceding its block in scan order, cold-starts the recurrence there,
    and discards the warm-up outputs.  Fully parallel (linear scaling);
    exact wherever every path's last reset (seed or edge re-entry) lies
    within the overlap window, asymptotically exact as overlap grows
    because SGM's normalized recurrence forgets its carry geometrically.
    ``overlap`` may exceed the tile height: halos are then pulled from
    multiple predecessors with multi-hop ppermutes (overlap >= (n-1)*Hl
    reconstructs every tile's state from the scan start — bit-exact).
    Tile 0 is always exact: a zero-cost halo is the recurrence's identity
    (prev == 0 makes band == 0, so L == C, the seeded start).

Diagonal sweeps need no special casing on top of this: their carry shift is
along W (unsharded), and reversed traversals flip the local block while the
hand-off/halo direction flips in rank space.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import numpy as np

import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.aggregation import sgm_scan_with_carry
from ..ops.cost import (birchfield_cost_volume, census_hamming_cost_volume,
                        sad_cost_from_padded, ssd_cost_from_padded,
                        zncc_cost_from_padded)
from ..ops.cvf import guided_filter_from_padded
from ..ops.disparity import dynamic_programming, winner_takes_all
from ..utils.backend import resolve_backend, sgm_scan_fn
from . import halo
from .mesh import BATCH_AXIS, TILE_AXIS

# np.float32, not jnp.float32: a jnp scalar is a device array and its
# construction at import time would initialize the backend; the numpy
# scalar promotes identically.
_INF = np.float32(np.inf)


def _varying(x):
    """Mark a shard_map-internal constant as device-varying.

    shard_map types every value with the mesh axes it varies over; loop and
    scan carries must keep that type stable, so constants that seed a carry
    which later mixes with ppermute'd/sharded data need an explicit cast.
    No-op for axes the value already varies over.
    """
    vma = getattr(jax.typeof(x), "vma", frozenset())
    missing = tuple(a for a in (BATCH_AXIS, TILE_AXIS) if a not in vma)
    if not missing:
        return x
    return lax.pcast(x, missing, to="varying")


# --------------------------------------------------------------------------
# Cost (local + halo)
# --------------------------------------------------------------------------

def _local_ssd(left, right, *, max_disparity, kernel_size, cost_dtype,
               axis_name):
    """[B, Hl, W] x2 -> [B, Hl, W, D] with neighbor row halos."""
    k = kernel_size
    lpad = halo.pad_with_halos(left, k, k - 1, axis=1, axis_name=axis_name)
    rpad = halo.pad_with_halos(right, k, k - 1, axis=1, axis_name=axis_name)
    fn = functools.partial(ssd_cost_from_padded, pad_before=k,
                           pad_after=k - 1, max_disparity=max_disparity,
                           kernel_size=kernel_size, cost_dtype=cost_dtype)
    return jax.vmap(fn)(lpad, rpad)


def _local_sad(left, right, *, max_disparity, kernel_size, cost_dtype,
               axis_name):
    """SAD under row sharding: identical halo pattern to _local_ssd."""
    k = kernel_size
    lpad = halo.pad_with_halos(left, k, k - 1, axis=1, axis_name=axis_name)
    rpad = halo.pad_with_halos(right, k, k - 1, axis=1, axis_name=axis_name)
    fn = functools.partial(sad_cost_from_padded, pad_before=k,
                           pad_after=k - 1, max_disparity=max_disparity,
                           kernel_size=kernel_size, cost_dtype=cost_dtype)
    return jax.vmap(fn)(lpad, rpad)


def _local_zncc(left, right, *, max_disparity, kernel_size, cost_dtype,
                axis_name, n_tiles):
    """ZNCC under row sharding — bit-equal to the single-chip volume.

    Same (k, k-1) image-row halos as SSD, plus a per-row validity mask:
    halo rows that fall outside the true image (ppermute zero fill at
    ranks 0 and n-1) must not enter the window *count* statistic — zero
    is the additive identity for the sums but not for the count.  The
    padded body is the single-chip prefix-plane formulation (round 5),
    which needs two global-geometry inputs reproduced exactly: the
    per-image centering means (per-row sums all-gathered, then every
    chip re-reduces the identical [H] vector — stable_image_mean's
    association).
    """
    from ..ops.cost import pairwise_sum_last

    k = kernel_size
    h_global = n_tiles * left.shape[1]
    # pairwise_sum_last's fixed add chain (not jnp.sum, whose reduce
    # tree shifts with fusion context) is what makes these scalars
    # bit-identical to stable_image_mean's single-chip values.
    row_sums_l = lax.all_gather(pairwise_sum_last(
        left.astype(jnp.float32)), axis_name, axis=1, tiled=True)  # [B, H]
    row_sums_r = lax.all_gather(pairwise_sum_last(
        right.astype(jnp.float32)), axis_name, axis=1, tiled=True)
    size = h_global * left.shape[2]
    mean_l = pairwise_sum_last(row_sums_l) / size                # [B]
    mean_r = pairwise_sum_last(row_sums_r) / size
    lpad = halo.pad_with_halos(left, k, k - 1, axis=1, axis_name=axis_name)
    rpad = halo.pad_with_halos(right, k, k - 1, axis=1, axis_name=axis_name)
    row_valid = ~halo.out_of_image_mask(axis_name, n_tiles,
                                        left.shape[1], k, k - 1)
    fn = functools.partial(zncc_cost_from_padded, pad_before=k,
                           pad_after=k - 1, max_disparity=max_disparity,
                           kernel_size=kernel_size, cost_dtype=cost_dtype)
    return jax.vmap(lambda l, r, ml, mr: fn(l, r, row_valid=row_valid,
                                            left_mean=ml, right_mean=mr))(
        lpad, rpad, mean_l, mean_r)


def _local_cvf(vol, guide, *, radius, eps, axis_name, n_tiles):
    """Guided-filter aggregation under row sharding (ops/cvf.py).

    Both filter stages are (2r+1) box means, so the output row depends on
    input rows within ±2*radius: pull that many halo rows of the volume
    and the guide, filter, crop.  Halo rows beyond the true image (the
    ppermute zero fill at ranks 0 and n-1) are poisoned to +inf so the
    filter's validity mask excludes them — zero is NOT the identity for
    the window-count statistic (same trick as _local_zncc's row_valid).
    Identity-zero summation order then matches the single-chip
    reduce_window program, so the crop is bit-exact (asserted by
    tests/test_cvf.py on the CPU mesh).
    """
    h = 2 * radius
    h_local = guide.shape[1]
    if h > h_local:
        raise ValueError(
            f"cvf radius {radius} needs {h} halo rows but tiles are only "
            f"{h_local} rows tall; use fewer tiles or a smaller radius")
    vpad = halo.pad_with_halos(vol, h, h, axis=1, axis_name=axis_name)
    gpad = halo.pad_with_halos(guide, h, h, axis=1, axis_name=axis_name)
    oob = halo.out_of_image_mask(axis_name, n_tiles, h_local, h)
    vpad = jnp.where(oob[None, :, None, None],
                     jnp.asarray(jnp.inf, vpad.dtype), vpad)
    fn = functools.partial(guided_filter_from_padded, pad_before=h,
                           pad_after=h, radius=radius, eps=eps)
    return jax.vmap(fn)(vpad, gpad)


def _local_birchfield(left, right, *, max_disparity, kernel_size):
    """Birchfield cost is scanline-local: no halo exchange needed."""
    fn = functools.partial(birchfield_cost_volume.__wrapped__,
                           max_disparity=max_disparity,
                           kernel_size=kernel_size)
    return jax.vmap(fn)(left, right)


def _local_census(left, right, *, max_disparity, window_size, cost_dtype):
    """Census + Hamming under row sharding: ±(window//2) image-row halos
    feed the census window; the Hamming stage is row-local.

    ppermute's zero fill at the true image edges IS the census
    transform's out-of-image convention (neighbors read 0), so computing
    on the halo-extended block and cropping reproduces the single-chip
    volume exactly.
    """
    h = window_size // 2
    lpad = halo.pad_with_halos(left, h, h, axis=1, axis_name=TILE_AXIS)
    rpad = halo.pad_with_halos(right, h, h, axis=1, axis_name=TILE_AXIS)

    def one(lp, rp):
        vol = census_hamming_cost_volume.__wrapped__(
            lp, rp, max_disparity=max_disparity, window_size=window_size,
            cost_dtype=cost_dtype)
        return vol[h:vol.shape[0] - h]

    return jax.vmap(one)(lpad, rpad)


# --------------------------------------------------------------------------
# SGM sweeps under row sharding
# --------------------------------------------------------------------------

def _rank_and_perm(axis_name: str, n_tiles: int, reverse: bool):
    """Scan-order rank of this tile and the carry-passing permutation."""
    p = lax.axis_index(axis_name)
    if reverse:
        return n_tiles - 1 - p, [(i, i - 1) for i in range(1, n_tiles)]
    return p, [(i, i + 1) for i in range(n_tiles - 1)]


def _pull_prev_in_rank(x, count, perm, axis_name, n_tiles):
    """Last ``count`` (<= block height) rows of the previous-in-rank tile."""
    edge = lax.slice_in_dim(x, x.shape[1] - count, x.shape[1], axis=1)
    if n_tiles == 1:
        return jnp.zeros_like(edge)
    return lax.ppermute(edge, axis_name, perm=perm)


def _pull_preceding_rows(x, count, axis_name, n_tiles, perm_dir=1):
    """The ``count`` rows (axis 1) immediately preceding this tile's block in
    scan order, zero-filled before the start of the scan.

    ``count`` may exceed the local block height Hl: rows are then pulled from
    ceil(count/Hl) predecessors with multi-hop ppermutes, so warm-up windows
    are not capped at one tile (a tile whose halo reaches the scan start
    reconstructs the recurrence state exactly — zero fill is the identity).

    ``perm_dir``: +1 when scan order follows increasing rank; -1 for
    reversed scans operating on locally-flipped blocks.
    """
    h_loc = x.shape[1]
    if count == 0:
        return lax.slice_in_dim(x, 0, 0, axis=1)
    n_hops = -(-count // h_loc)
    pieces = []
    for j in range(n_hops, 0, -1):          # farthest predecessor first
        take = count - (j - 1) * h_loc if j == n_hops else h_loc
        edge = lax.slice_in_dim(x, h_loc - take, h_loc, axis=1)
        if j >= n_tiles:
            pieces.append(_varying(jnp.zeros_like(edge)))
        elif perm_dir > 0:
            perm = [(i, i + j) for i in range(n_tiles - j)]
            pieces.append(lax.ppermute(edge, axis_name, perm=perm))
        else:
            perm = [(i, i - j) for i in range(j, n_tiles)]
            pieces.append(lax.ppermute(edge, axis_name, perm=perm))
    return pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, axis=1)


def _pull_following_rows(x, count, axis_name, n_tiles):
    """First ``count`` rows of the successor tiles in rank order (the rows
    that follow this block in image order), zero-filled past the end.

    Multi-hop counterpart of :func:`_pull_preceding_rows` for reverse
    sweeps that append the warm-up halo instead of flipping the block.
    """
    h_loc = x.shape[1]
    if count == 0:
        return lax.slice_in_dim(x, 0, 0, axis=1)
    n_hops = -(-count // h_loc)
    pieces = []
    for j in range(1, n_hops + 1):          # nearest successor first
        take = count - (j - 1) * h_loc if j == n_hops else h_loc
        edge = lax.slice_in_dim(x, 0, take, axis=1)
        if j >= n_tiles:
            pieces.append(_varying(jnp.zeros_like(edge)))
        else:
            perm = [(i, i - j) for i in range(j, n_tiles)]
            pieces.append(lax.ppermute(edge, axis_name, perm=perm))
    return pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, axis=1)


def _effective_overlap(overlap: int, h_loc: int, n_tiles: int) -> int:
    """Clamp the warm-up window to the longest useful span: the deepest tile
    has (n_tiles-1)*Hl true predecessor rows; anything longer only adds
    zero-identity rows."""
    return min(overlap, max((n_tiles - 1) * h_loc, 0))


def _handoff_sweep(vol, img, p1, p2, carry_shift, *, axis_name, n_tiles,
                   reverse, scan=sgm_scan_with_carry):
    """Exact chunked sweep: FRAME-PIPELINED carry hand-off across tiles.

    vol/img are already W-flipped if the family needs it; this function
    applies the scan-direction (H) flip locally and reverses rank order.

    The naive hand-off (:func:`_handoff_sweep_naive`) runs ``n_tiles``
    stages, every stage computing ALL local frames vmapped and keeping
    only the stage's active tile — T*B chunk computations per device for
    B useful ones.  The serial chain is
    instead hidden behind the batch axis as a (frame, tile) wavefront:
    at stage s, the tile with scan rank r advances frame ``s - r``, so
    every tile is busy once the pipeline fills — ``T + B - 1`` stages of
    ONE frame each, the identical per-frame computation in the identical
    order (bit-equal output), ~min(T, B)x less compute.  B = 1
    degenerates to the naive schedule exactly.
    """
    if reverse:
        vol, img = vol[:, ::-1], img[:, ::-1]
    rank, perm = _rank_and_perm(axis_name, n_tiles, reverse)
    batch, _, width, max_disp = vol.shape

    scan_one = lambda c, im, cc, ci, seed: scan(  # noqa: E731
        c, im, p1, p2, carry_shift, init_carry=(cc, ci), seed_first=seed)
    seed = rank == 0

    def stage(s, state):
        carry_c, carry_i, out = state
        f = s - rank                         # this tile's frame this stage
        valid = (f >= 0) & (f < batch)
        fc = jnp.clip(f, 0, batch - 1)
        v = lax.dynamic_index_in_dim(vol, fc, axis=0, keepdims=False)
        im = lax.dynamic_index_in_dim(img, fc, axis=0, keepdims=False)
        (fin_c, fin_i), contrib = scan_one(v, im, carry_c, carry_i, seed)
        # Write the slab read-modify-write so the select stays slab-sized
        # (a whole-batch where would re-copy out every stage).
        cur = lax.dynamic_index_in_dim(out, fc, axis=0, keepdims=False)
        out = lax.dynamic_update_index_in_dim(
            out, jnp.where(valid, contrib, cur), fc, axis=0)
        carry_c = jnp.where(valid, fin_c, carry_c)
        carry_i = jnp.where(valid, fin_i, carry_i)
        if n_tiles > 1:
            carry_c = lax.ppermute(carry_c, axis_name, perm)
            carry_i = lax.ppermute(carry_i, axis_name, perm)
        return carry_c, carry_i, out

    init = (_varying(jnp.full((width, max_disp), _INF)),
            _varying(jnp.zeros((width,), jnp.float32)),
            _varying(jnp.zeros_like(vol)))
    _, _, out = lax.fori_loop(0, n_tiles + batch - 1, stage, init)

    if reverse:
        out = out[:, ::-1]
    return out


def _handoff_sweep_naive(vol, img, p1, p2, carry_shift, *, axis_name,
                         n_tiles, reverse, scan=sgm_scan_with_carry):
    """The all-frames-every-stage hand-off schedule (one tile kept per
    stage) — faster than the wavefront at small batches, and its parity
    witness: both must produce identical volumes."""
    if reverse:
        vol, img = vol[:, ::-1], img[:, ::-1]
    rank, perm = _rank_and_perm(axis_name, n_tiles, reverse)
    batch, _, width, max_disp = vol.shape

    scan_fn = jax.vmap(
        lambda c, im, cc, ci, seed: scan(
            c, im, p1, p2, carry_shift, init_carry=(cc, ci),
            seed_first=seed),
        in_axes=(0, 0, 0, 0, None))
    seed = rank == 0

    def stage(s, state):
        carry_c, carry_i, out = state
        (fin_c, fin_i), contrib = scan_fn(vol, img, carry_c, carry_i, seed)
        mine = rank == s
        out = jnp.where(mine, contrib, out)
        carry_c = jnp.where(mine, fin_c, carry_c)
        carry_i = jnp.where(mine, fin_i, carry_i)
        if n_tiles > 1:
            carry_c = lax.ppermute(carry_c, axis_name, perm)
            carry_i = lax.ppermute(carry_i, axis_name, perm)
        return carry_c, carry_i, out

    init = (_varying(jnp.full((batch, width, max_disp), _INF)),
            _varying(jnp.zeros((batch, width), jnp.float32)),
            _varying(jnp.zeros_like(vol)))
    _, _, out = lax.fori_loop(0, n_tiles, stage, init)

    if reverse:
        out = out[:, ::-1]
    return out


def _overlap_sweep(vol, img, p1, p2, carry_shift, *, axis_name, n_tiles,
                   reverse, overlap, scan=sgm_scan_with_carry):
    """Warm-up halo sweep: cold-start ``overlap`` rows early, in parallel.

    The halo for the first-in-scan-order tile is ppermute's zero fill, which
    is the recurrence identity (band == 0 -> L == C), so that tile stays
    exact regardless of ``overlap``.
    """
    if reverse:
        vol, img = vol[:, ::-1], img[:, ::-1]
    overlap = _effective_overlap(overlap, vol.shape[1], n_tiles)
    perm_dir = -1 if reverse else 1

    halo_v = _pull_preceding_rows(vol, overlap, axis_name, n_tiles, perm_dir)
    halo_i = _pull_preceding_rows(img, overlap, axis_name, n_tiles, perm_dir)
    vol_x = jnp.concatenate([halo_v, vol], axis=1)
    img_x = jnp.concatenate([halo_i, img], axis=1)

    scan_fn = jax.vmap(
        lambda c, im, cc, ci: scan(
            c, im, p1, p2, carry_shift, init_carry=(cc, ci))[1])
    batch, _, width, max_disp = vol.shape
    out = scan_fn(vol_x, img_x,
                  _varying(jnp.full((batch, width, max_disp), _INF)),
                  _varying(jnp.zeros((batch, width), jnp.float32)))
    out = out[:, overlap:]

    if reverse:
        out = out[:, ::-1]
    return out


def _local_horizontal_sweep(vol, img, p1, p2, reverse,
                            scan=sgm_scan_with_carry):
    """Horizontal sweeps scan along W: fully local under row sharding."""
    v = jnp.swapaxes(vol, 1, 2)                    # [B, W, Hl, D]
    im = jnp.swapaxes(img, 1, 2)
    if reverse:
        v, im = v[:, ::-1], im[:, ::-1]
    batch, _, n_rows, max_disp = v.shape
    scan_fn = jax.vmap(
        lambda c, i, cc, ci: scan(
            c, i, p1, p2, 0, init_carry=(cc, ci))[1])
    out = scan_fn(v, im,
                  _varying(jnp.full((batch, n_rows, max_disp), _INF)),
                  _varying(jnp.zeros((batch, n_rows), jnp.float32)))
    if reverse:
        out = out[:, ::-1]
    return jnp.swapaxes(out, 1, 2)


def _local_horizontal(vol, img, p1, p2, backend):
    """Both horizontal traversals, summed (forward first).  The Hopper
    kernel scans along W in place; the XLA scan needs the transpose."""
    if backend == "cuda":
        from ..ops.sgm_cuda import sweep

        def both(v, im):
            out, _ = sweep(v, im, penalty1=p1, penalty2=p2, transpose=True)
            out, _ = sweep(v, im, penalty1=p1, penalty2=p2, transpose=True,
                           flip_s=True, acc=out)
            return out
        return jax.vmap(both)(vol, img)
    scan = sgm_scan_fn(backend)
    out = _local_horizontal_sweep(vol, img, p1, p2, False, scan)
    return out + _local_horizontal_sweep(vol, img, p1, p2, True, scan)


def sharded_semiglobal(cost_vol, left_image, *, penalty1, penalty2,
                       axis_name, n_tiles, mode="exact", overlap=64,
                       schedule="wavefront", backend="xla"):
    """8-direction SGM over a row-sharded [B, Hl, W, D] volume.

    Matches ops.aggregation.semiglobal_aggregate per tile-block; ``mode``
    selects how the 6 scan-crossing sweeps split the H axis (see module
    docstring).  For the exact mode, ``schedule`` picks the hand-off
    fill ("wavefront" or "naive" — bit-identical outputs; the
    interconnect model's select_exact_schedule knows which is faster at
    a given (tiles, batch)).  ``backend`` ("cuda" or "xla", already
    resolved) picks the per-tile sweep: both honour the carry contract
    of ops.aggregation.sgm_scan_with_carry.
    """
    scan = sgm_scan_fn(backend)
    vol = cost_vol.astype(jnp.float32)
    img = left_image.astype(jnp.float32)

    if mode == "exact":
        if schedule not in ("wavefront", "naive"):
            raise ValueError(f"unknown exact schedule: {schedule!r}")
        fn = (_handoff_sweep if schedule == "wavefront"
              else _handoff_sweep_naive)
        sweep = functools.partial(fn, axis_name=axis_name,
                                  n_tiles=n_tiles, scan=scan)
    elif mode == "overlap":
        sweep = functools.partial(_overlap_sweep, axis_name=axis_name,
                                  n_tiles=n_tiles, overlap=overlap,
                                  scan=scan)
    else:
        raise ValueError(f"unknown SGM sharding mode: {mode!r}")

    out = _local_horizontal(vol, img, penalty1, penalty2, backend)
    # Vertical family: scan over H, no carry shift.
    out += sweep(vol, img, penalty1, penalty2, 0, reverse=False)
    out += sweep(vol, img, penalty1, penalty2, 0, reverse=True)
    # Diagonal (1, 1): predecessor one column left; reverse flips W locally
    # (the rank flip supplies the H direction), matching _sweep_diagonal.
    out += sweep(vol, img, penalty1, penalty2, 1, reverse=False)
    out += sweep(vol[:, :, ::-1], img[:, :, ::-1], penalty1, penalty2, 1,
                 reverse=True)[:, :, ::-1]
    # Diagonal (-1, 1): predecessor one column right.
    out += sweep(vol, img, penalty1, penalty2, -1, reverse=False)
    out += sweep(vol[:, :, ::-1], img[:, :, ::-1], penalty1, penalty2, -1,
                 reverse=True)[:, :, ::-1]
    return out.astype(cost_vol.dtype)


# --------------------------------------------------------------------------
# Whole-pipeline assembly
# --------------------------------------------------------------------------

def _median3x3_rows(disp, *, axis_name, n_tiles):
    """3x3 median over row shards: one disparity-row halo per neighbor;
    ring ends replicate the local edge row, matching the single-chip
    filter's ``mode="edge"`` padding (ops/refine.py::median_filter_3x3).
    [B, Hl, W] -> [B, Hl, W]."""
    top = halo.pull_from_prev(disp, 1, axis=1, axis_name=axis_name)
    bottom = halo.pull_from_next(disp, 1, axis=1, axis_name=axis_name)
    rank = lax.axis_index(axis_name)
    top = jnp.where(rank == 0, disp[:, :1], top)
    bottom = jnp.where(rank == n_tiles - 1, disp[:, -1:], bottom)
    x = jnp.concatenate([top, disp, bottom], axis=1).astype(jnp.float32)
    x = jnp.pad(x, ((0, 0), (0, 0), (1, 1)), mode="edge")
    b, hl, w = disp.shape
    planes = [x[:, dy:dy + hl, dx:dx + w]
              for dy in range(3) for dx in range(3)]
    return jnp.sort(jnp.stack(planes, axis=-1),
                    axis=-1)[..., 4].astype(disp.dtype)


def _wmf_rows(disp, guide, *, window, sigma, n_bins, axis_name, n_tiles):
    """Guide-weighted median under row sharding: ±window//2 halo rows of
    the disparity bins AND the guide, ring-end guide halo rows overwritten
    with +inf (zero affinity — the single-chip out-of-image convention),
    W padded locally.  Bit-identical to ops.refine.weighted_median_filter
    on the assembled image.  [B, Hl, W] -> same."""
    from ..ops import refine

    r = window // 2
    bins = jnp.clip(jnp.round(disp.astype(jnp.float32)),
                    0, n_bins - 1).astype(jnp.int32)
    g = guide.astype(jnp.float32)
    b_pad = halo.pad_with_halos(bins, r, r, axis=1, axis_name=axis_name)
    g_pad = halo.pad_with_halos(g, r, r, axis=1, axis_name=axis_name)
    rank = lax.axis_index(axis_name)
    inf = jnp.float32(jnp.inf)
    top = jnp.where(rank == 0, inf, g_pad[:, :r])
    bottom = jnp.where(rank == n_tiles - 1, inf, g_pad[:, -r:])
    g_pad = jnp.concatenate([top, g_pad[:, r:-r], bottom], axis=1)
    b_pad = jnp.pad(b_pad, ((0, 0), (0, 0), (r, r)))
    g_pad = jnp.pad(g_pad, ((0, 0), (0, 0), (r, r)),
                    constant_values=jnp.inf)
    out = jax.vmap(functools.partial(refine._wmf_from_padded,
                                     window=window, sigma=sigma,
                                     n_bins=n_bins))(b_pad, g_pad, g)
    return out.astype(disp.dtype)


def _fgs_rows(disp, guide, confidence, *, lam, sigma_color, iterations,
              axis_name, n_tiles):
    """Fast global smoother under row sharding (ops.refine.fgs_smooth).

    The horizontal tridiagonal solves never leave a row — row-local.
    The vertical solves span every tile: Thomas forward elimination
    chains its (cp, dp) carry DOWN through the ranks and back
    substitution chains the first-row solution UP, sequentially like
    the exact DP hand-off (each rank recomputes its local sweep at its
    stage from the incoming carry, so the scans run the single-chip
    recurrence; agreement is to float-associativity noise — XLA fuses
    the elementwise system-building differently inside the shard_map
    program, measured <= 4e-4 over 3 iterations).  Boundary smoothness
    weights come from one guide halo row per side; ring ends get weight
    0, which zeroes the boundary coupling so the ppermute zero carry is
    exactly the single-chip border seed.
    """
    from ..ops import refine

    u = disp.astype(jnp.float32)
    g = guide.astype(jnp.float32)
    c = refine._fgs_confidence(u, confidence)
    inv_sigma = np.float32(-1.0) / jnp.asarray(sigma_color, jnp.float32)
    a_h = jnp.exp(jnp.abs(g[..., :, 1:] - g[..., :, :-1]) * inv_sigma)

    rank = lax.axis_index(axis_name)
    a_v = jnp.exp(jnp.abs(g[:, 1:] - g[:, :-1]) * inv_sigma)
    g_up = halo.pull_from_prev(g, 1, 1, axis_name)        # [B, 1, W]
    g_dn = halo.pull_from_next(g, 1, 1, axis_name)
    a_up = jnp.exp(jnp.abs(g[:, :1] - g_up) * inv_sigma)
    a_dn = jnp.exp(jnp.abs(g[:, -1:] - g_dn) * inv_sigma)
    zero_row = jnp.zeros_like(a_up)
    a_up = jnp.where(rank == 0, zero_row, a_up)
    a_dn = jnp.where(rank == n_tiles - 1, zero_row, a_dn)
    a_left_v = jnp.concatenate([a_up, a_v], axis=1)
    a_right_v = jnp.concatenate([a_v, a_dn], axis=1)

    fwd_perm = [(i, i + 1) for i in range(n_tiles - 1)]
    bwd_perm = [(i + 1, i) for i in range(n_tiles - 1)]

    def vertical(u_cur, lam_t):
        swap = lambda x: jnp.moveaxis(x, 1, -1)         # noqa: E731
        diag, off, b, off_prev = refine._fgs_system(
            swap(u_cur), swap(c), swap(a_left_v), swap(a_right_v), lam_t)
        z = jnp.zeros_like(diag[..., 0])

        def fstage(s, state):
            cp_in, dp_in, cps_acc, dps_acc = state
            cps, dps = refine._thomas_forward(diag, off, b, off_prev,
                                              cp_in, dp_in)
            mine = rank == s
            cps_acc = jnp.where(mine, cps, cps_acc)
            dps_acc = jnp.where(mine, dps, dps_acc)
            cp_out = jnp.where(mine, cps[..., -1], cp_in)
            dp_out = jnp.where(mine, dps[..., -1], dp_in)
            if n_tiles > 1:
                cp_out = lax.ppermute(cp_out, axis_name, fwd_perm)
                dp_out = lax.ppermute(dp_out, axis_name, fwd_perm)
            return cp_out, dp_out, cps_acc, dps_acc

        _, _, cps, dps = lax.fori_loop(
            0, n_tiles, fstage, (z, z, jnp.zeros_like(diag),
                                 jnp.zeros_like(diag)))

        def bstage(s, state):
            u_next, out = state
            v = refine._thomas_backward(cps, dps, u_next)
            mine = rank == n_tiles - 1 - s
            out = jnp.where(mine, v, out)
            u0 = jnp.where(mine, v[..., 0], u_next)
            if n_tiles > 1:
                u0 = lax.ppermute(u0, axis_name, bwd_perm)
            return u0, out

        _, out = lax.fori_loop(0, n_tiles, bstage,
                               (z, jnp.zeros_like(diag)))
        return jnp.moveaxis(out, -1, 1)

    lam = jnp.asarray(lam, jnp.float32)
    total = iterations
    for t in range(1, total + 1):
        lam_t = refine._fgs_lambda_schedule(lam, total, t)
        u = refine._fgs_pass(u, c, a_h, lam_t)          # row-local
        u = vertical(u, lam_t)
    return u


def _speckle_rows(disp, *, max_diff, window, min_frac, fill,
                  axis_name, n_tiles):
    """Windowed-support speckle suppression under row sharding: pull
    ±window//2 disparity-row halos, overwrite ring-end halo rows with
    NaN (the single-chip filter's out-of-image convention — ppermute's
    zero fill would count as agreeing d=0 neighbors), pad W with NaN
    locally, and run the shared support test.  [B, Hl, W] -> same."""
    from ..ops import refine

    r = window // 2
    d = disp.astype(jnp.float32)
    padded = halo.pad_with_halos(d, r, r, axis=1, axis_name=axis_name)
    rank = lax.axis_index(axis_name)
    nan = jnp.float32(jnp.nan)
    top = jnp.where(rank == 0, nan, padded[:, :r])
    bottom = jnp.where(rank == n_tiles - 1, nan, padded[:, -r:])
    padded = jnp.concatenate([top, padded[:, r:-r], bottom], axis=1)
    padded = jnp.pad(padded, ((0, 0), (0, 0), (r, r)),
                     constant_values=jnp.nan)
    mask = jax.vmap(functools.partial(
        refine._windowed_support, max_diff=max_diff, window=window,
        min_frac=min_frac))(padded, d)
    if fill == "zero":
        return jnp.where(mask, disp, jnp.zeros((), disp.dtype))
    if fill == "background":
        return jax.vmap(refine.fill_inconsistent)(disp, mask).astype(
            jnp.promote_types(disp.dtype, jnp.float32))
    raise ValueError(f"unknown fill mode: {fill!r}")


def make_sharded_estimate(mesh, *, max_disparity: int,
                          cost: str = "ssd",
                          kernel_size: Optional[int] = None,
                          cost_dtype=jnp.float32,
                          census_window: int = 5,
                          aggregation: Optional[str] = "sgm",
                          reducer: str = "wta",
                          penalty1: float = 0.1, penalty2: float = 0.2,
                          cvf_radius: int = 8, cvf_eps: float = 1e-4,
                          sgm_mode: str = "exact",
                          sgm_schedule: str = "auto",
                          overlap: int = 64,
                          backend: str = "auto",
                          median: bool = False,
                          subpixel: bool = False,
                          lr_check: bool = False,
                          lr_mode: str = "mirror",
                          lr_max_diff: int = 1,
                          weighted_median: bool = False,
                          wmf_sigma: float = 10.0,
                          wmf_window: int = 5,
                          fgs_lambda: Optional[float] = None,
                          fgs_sigma: float = 8.0,
                          min_confidence: Optional[float] = None,
                          speckle: bool = False,
                          speckle_fill: str = "zero") -> Callable:
    """Compile the full pipeline over a (batch, tile) mesh.

    Returns a jitted ``fn(left, right) -> disparity`` over batched stacks:
    [B, H, W] float -> [B, H, W] int32, with B divisible by the batch axis
    and H by the tile axis.  One XLA program: cost construction (with image
    halo exchange), optional 8-path SGM (carry hand-off or warm-up halos),
    and the reducer, all fused — no per-stage host sync anywhere.

    ``median``/``subpixel``/``lr_check``/``min_confidence`` mirror the
    single-chip ``Pipeline.estimate_refined`` surface and ordering
    (LR fill, median, sub-pixel, confidence gate).  Every stage is
    row-local under the tile sharding except the median (one
    disparity-row halo per neighbor, edge-replicated at ring ends); the
    LR check's mirrored run flips W, which row sharding never splits.
    With ``subpixel`` the output becomes float32.

    ``lr_mode`` follows ``Pipeline.estimate_refined``: ``"mirror"`` runs
    the pipeline a second time on W-flipped inputs; ``"volume"``
    re-indexes the aggregated volume (C_R[y,x,d] = C_L[y,x+d,d] — pure
    row-local W shifts, so it needs no halo under row sharding and costs
    one extra volume pass instead of a second pipeline).
    """
    if lr_mode not in ("mirror", "volume"):
        raise ValueError(f"unknown lr_mode: {lr_mode!r}")
    if sgm_mode not in ("exact", "overlap", "auto"):
        raise ValueError(f"unknown sgm_mode: {sgm_mode!r} (expected "
                         "'exact', 'overlap' or 'auto' — auto resolves "
                         "from the interconnect model, "
                         "parallel/ici_model.py)")
    if sgm_schedule not in ("auto", "wavefront", "naive"):
        raise ValueError(f"unknown sgm_schedule: {sgm_schedule!r} "
                         "(expected 'auto', 'wavefront' or 'naive')")
    if cost not in ("ssd", "ssd-texture", "birchfield", "census", "sad",
                    "ncc"):
        raise ValueError(f"unknown cost: {cost!r}")
    if reducer not in ("wta", "dynamic_programming"):
        raise ValueError(f"unknown reducer: {reducer!r}")
    if aggregation not in (None, "sgm", "cvf"):
        raise ValueError(f"unknown aggregation: {aggregation!r}")
    if aggregation == "cvf" and not jnp.issubdtype(jnp.dtype(cost_dtype),
                                                   jnp.floating):
        raise ValueError("cvf aggregation computes windowed means, a float "
                         f"quantity; got cost_dtype {cost_dtype}")
    if kernel_size is None:
        kernel_size = {"birchfield": 4, "census": 1}.get(cost, 7)
    if cost == "census" and kernel_size != 1:
        raise ValueError(
            "sharded census supports kernel_size=1 (pixelwise Hamming) "
            "only: a box window across row-tile boundaries cannot "
            "reproduce the single-chip clipped sum at true image edges")
    n_tiles = mesh.shape[TILE_AXIS]

    backend = resolve_backend(backend)

    def core(left, right):                  # [B_loc, Hl, W] -> (vol, disp)
        # "ssd-texture" = the texture sampler (identity over integer pixel
        # centres under nearest/unnormalized — texture.py sample_grid) into
        # float32 SSD, bit-matching the single-chip SSDTexture config.
        if cost in ("ssd", "ssd-texture"):
            vol = _local_ssd(left, right, max_disparity=max_disparity,
                             kernel_size=kernel_size,
                             cost_dtype=(jnp.float32 if cost == "ssd-texture"
                                         else cost_dtype),
                             axis_name=TILE_AXIS)
        elif cost == "sad":
            vol = _local_sad(left, right, max_disparity=max_disparity,
                             kernel_size=kernel_size, cost_dtype=cost_dtype,
                             axis_name=TILE_AXIS)
        elif cost == "ncc":
            vol = _local_zncc(left, right, max_disparity=max_disparity,
                              kernel_size=kernel_size, cost_dtype=cost_dtype,
                              axis_name=TILE_AXIS, n_tiles=n_tiles)
        elif cost == "census":
            vol = _local_census(left, right, max_disparity=max_disparity,
                                window_size=census_window,
                                cost_dtype=cost_dtype)
        else:
            vol = _local_birchfield(left, right,
                                    max_disparity=max_disparity,
                                    kernel_size=kernel_size)
        if aggregation == "sgm":
            mode = sgm_mode
            if mode == "auto":
                # Resolve from the interconnect model at trace time with
                # the mesh devices' published rates (shapes are
                # concrete here): exact preferred within 5% — it is
                # bit-exact vs the single chip — overlap only when the
                # model says the carry chain genuinely dominates.  The
                # frame-pipelined hand-off means batch size enters the
                # prediction.
                from .ici_model import select_sgm_mode
                mode, info = select_sgm_mode(
                    height=left.shape[1] * n_tiles, width=left.shape[2],
                    disp=max_disparity, tiles=n_tiles,
                    batch=left.shape[0], overlap=overlap,
                    device_kind=mesh.devices.flat[0].device_kind)
                import logging
                logging.getLogger(__name__).info(
                    "sgm_mode=auto resolved to %r (%s)", mode, info)
            sched = sgm_schedule
            if sched == "auto" and mode == "exact":
                # The wavefront loses to the naive hand-off at small
                # batches (CPU-mesh A/B: 29.23 vs 27.44 ms at batch 2) —
                # let the model pick per (tiles, batch).
                from .ici_model import select_exact_schedule
                sched, sinfo = select_exact_schedule(
                    tiles=n_tiles, batch=left.shape[0])
                import logging
                logging.getLogger(__name__).info(
                    "sgm_schedule=auto resolved to %r (%s)", sched, sinfo)
            elif sched == "auto":
                sched = "wavefront"
            vol = sharded_semiglobal(vol, left, penalty1=penalty1,
                                     penalty2=penalty2, axis_name=TILE_AXIS,
                                     n_tiles=n_tiles, mode=mode,
                                     overlap=overlap, schedule=sched,
                                     backend=backend)
        elif aggregation == "cvf":
            vol = _local_cvf(vol, left, radius=cvf_radius, eps=cvf_eps,
                             axis_name=TILE_AXIS, n_tiles=n_tiles)
        if reducer == "wta":
            return vol, jax.vmap(winner_takes_all.__wrapped__)(vol)
        return vol, jax.vmap(dynamic_programming.__wrapped__)(vol)

    def local_fn(left, right):                     # [B_loc, Hl, W]
        from ..ops import refine

        left = left.astype(jnp.float32)
        right = right.astype(jnp.float32)
        if lr_check and lr_mode == "mirror":
            # Right-to-left matching is left-to-right matching on
            # mirrored images (ops/refine.py::right_disparity); the W
            # flip is tile-local under row sharding.
            disp_r = core(right[:, :, ::-1],
                          left[:, :, ::-1])[1][:, :, ::-1]
        agg, disp = core(left, right)
        if lr_check:
            if lr_mode == "volume":
                # The d-plane re-index never leaves the row, so it is
                # exactly the single-chip op per tile.
                disp_r = jax.vmap(
                    refine.right_disparity_from_volume.__wrapped__)(agg)
            mask = jax.vmap(functools.partial(
                refine.left_right_consistency.__wrapped__,
                max_diff=lr_max_diff,
                max_disparity=max_disparity))(disp, disp_r)
            disp = jax.vmap(refine.fill_inconsistent)(disp, mask)
        if weighted_median:
            disp = _wmf_rows(disp, left, window=wmf_window,
                             sigma=wmf_sigma, n_bins=max_disparity,
                             axis_name=TILE_AXIS, n_tiles=n_tiles)
        if median:
            disp = _median3x3_rows(disp, axis_name=TILE_AXIS,
                                   n_tiles=n_tiles)
        if subpixel:
            idx = jnp.clip(jnp.round(disp), 0,
                           max_disparity - 1).astype(jnp.int32)
            disp = jax.vmap(refine.subpixel_refine.__wrapped__)(agg, idx)
        if fgs_lambda is not None:
            conf = (mask.astype(jnp.float32) if lr_check else None)
            disp = _fgs_rows(disp, left, conf, lam=fgs_lambda,
                             sigma_color=fgs_sigma, iterations=3,
                             axis_name=TILE_AXIS, n_tiles=n_tiles)
        if min_confidence is not None:
            conf = jax.vmap(refine.confidence_pkrn.__wrapped__)(agg)
            disp = jnp.where(conf >= min_confidence,
                             disp, jnp.zeros((), disp.dtype))
        if speckle:
            disp = _speckle_rows(disp, max_diff=1.0, window=9,
                                 min_frac=0.25, fill=speckle_fill,
                                 axis_name=TILE_AXIS, n_tiles=n_tiles)
        return disp

    spec = P(BATCH_AXIS, TILE_AXIS, None)
    # The kernel's FFI results carry their operands' varying-axes type
    # (ops/sgm_cuda.py::_vma), so shard_map's type check stays on for both
    # backends.
    mapped = shard_map(local_fn, mesh=mesh, in_specs=(spec, spec),
                       out_specs=spec)
    sharding = NamedSharding(mesh, spec)
    return jax.jit(mapped, in_shardings=(sharding, sharding),
                   out_shardings=sharding)


class ShardedPipeline:
    """Batched, mesh-sharded counterpart of :class:`stereomatch_tpu.Pipeline`.

    Configuration is by name (like the CLI registries, cli_common.py) because
    the sharded program is compiled as one unit rather than composed from
    stage callables.
    """

    def __init__(self, mesh, max_disparity: int, *, cost: str = "ssd",
                 kernel_size: Optional[int] = None,
                 cost_dtype=jnp.float32, census_window: int = 5,
                 aggregation: Optional[str] = "sgm", reducer: str = "wta",
                 penalty1: float = 0.1, penalty2: float = 0.2,
                 cvf_radius: int = 8, cvf_eps: float = 1e-4,
                 sgm_mode: str = "exact", sgm_schedule: str = "auto",
                 overlap: int = 64,
                 backend: str = "auto",
                 median: bool = False, subpixel: bool = False,
                 lr_check: bool = False, lr_mode: str = "mirror",
                 lr_max_diff: int = 1,
                 weighted_median: bool = False, wmf_sigma: float = 10.0,
                 wmf_window: int = 5,
                 fgs_lambda: Optional[float] = None, fgs_sigma: float = 8.0,
                 min_confidence: Optional[float] = None,
                 speckle: bool = False, speckle_fill: str = "zero"):
        self.mesh = mesh
        self.max_disparity = max_disparity
        self._fn = make_sharded_estimate(
            mesh, max_disparity=max_disparity, cost=cost,
            kernel_size=kernel_size, cost_dtype=cost_dtype,
            census_window=census_window,
            aggregation=aggregation, reducer=reducer,
            penalty1=penalty1, penalty2=penalty2,
            cvf_radius=cvf_radius, cvf_eps=cvf_eps, sgm_mode=sgm_mode,
            sgm_schedule=sgm_schedule,
            overlap=overlap, backend=backend, median=median,
            subpixel=subpixel, lr_check=lr_check, lr_mode=lr_mode,
            lr_max_diff=lr_max_diff, weighted_median=weighted_median,
            wmf_sigma=wmf_sigma, wmf_window=wmf_window,
            fgs_lambda=fgs_lambda, fgs_sigma=fgs_sigma,
            min_confidence=min_confidence, speckle=speckle,
            speckle_fill=speckle_fill)
        self._sharding = NamedSharding(mesh, P(BATCH_AXIS, TILE_AXIS, None))

    def estimate(self, left, right) -> jnp.ndarray:
        """[B, H, W] (or [H, W], auto-batched) -> [B, H, W] int32."""
        left = jnp.asarray(left)
        right = jnp.asarray(right)
        squeeze = left.ndim == 2
        if squeeze:
            n_batch = self.mesh.shape[BATCH_AXIS]
            left = jnp.broadcast_to(left, (n_batch,) + left.shape)
            right = jnp.broadcast_to(right, (n_batch,) + right.shape)
        n_batch = self.mesh.shape[BATCH_AXIS]
        n_tiles = self.mesh.shape[TILE_AXIS]
        if left.shape[0] % n_batch or left.shape[1] % n_tiles:
            raise ValueError(
                f"batch {left.shape[0]} / height {left.shape[1]} not "
                f"divisible by mesh axes {(n_batch, n_tiles)}")
        left = jax.device_put(left, self._sharding)
        right = jax.device_put(right, self._sharding)
        out = self._fn(left, right)
        return out[0] if squeeze else out
