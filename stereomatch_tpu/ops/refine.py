"""Disparity post-processing: sub-pixel refinement, median filtering,
left-right consistency (functional, jittable).

Beyond the reference's capability surface (its pipeline stops at integer
WTA/DP disparities) — these are the standard production-stereo refinement
steps, built as array programs: everything is a vectorized [H, W] map
operation (masked reductions and sorting networks), no data-dependent
control flow.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax


@jax.jit
def subpixel_refine(cost_volume: jnp.ndarray,
                    disparity: jnp.ndarray) -> jnp.ndarray:
    """Parabolic sub-pixel interpolation around the winning disparity.

    Fits a quadratic through (d-1, d, d+1) cost samples and returns the
    float32 disparity at its vertex:

        d* = d + (c[d-1] - c[d+1]) / (2 * (c[d-1] - 2 c[d] + c[d+1]))

    Border disparities (d = 0 or D-1) and degenerate/flat parabolas fall
    back to the integer estimate; the offset is clamped to [-0.5, 0.5]
    (the vertex of a valid local minimum always lies within).

    Formulation: instead of a per-pixel depth gather (``take_along_axis``
    at d-1/d/d+1), the three samples are one-hot masked reductions over
    the D axis (exactly one selected element per sum, the rest exactly
    0.0, so values are bit-identical to the gather): one fused O(H*W*D)
    vector sweep.  At the borders
    the shifted masks select nothing and yield 0 instead of the clamped
    plane — irrelevant, since ``interior`` already discards d=0/D-1.
    """
    height, width, max_disp = cost_volume.shape
    cost = cost_volume.astype(jnp.float32)
    d = disparity.astype(jnp.int32)

    d_iota = lax.broadcasted_iota(jnp.int32, cost.shape, 2)
    tgt = d[:, :, None]
    c0 = jnp.sum(jnp.where(d_iota == tgt, cost, 0.0), axis=2)
    cm = jnp.sum(jnp.where(d_iota == tgt - 1, cost, 0.0), axis=2)
    cp = jnp.sum(jnp.where(d_iota == tgt + 1, cost, 0.0), axis=2)

    denom = cm - 2.0 * c0 + cp
    offset = jnp.where(jnp.abs(denom) > 1e-12,
                       (cm - cp) / (2.0 * denom), 0.0)
    offset = jnp.clip(offset, -0.5, 0.5)
    interior = jnp.logical_and(d > 0, d < max_disp - 1)
    valid = jnp.logical_and(interior, jnp.isfinite(denom))
    return jnp.where(valid, d + offset, d).astype(jnp.float32)


@jax.jit
def median_filter_3x3(disparity: jnp.ndarray) -> jnp.ndarray:
    """3x3 median (edge-replicated), the classic speckle cleaner.

    Stacks the 9 neighbor planes and takes the middle of a per-pixel
    sort — O(H*W*9 log 9) elementwise work, no gathers.
    """
    x = disparity.astype(jnp.float32)
    padded = jnp.pad(x, 1, mode="edge")
    height, width = x.shape
    planes = [padded[dy:dy + height, dx:dx + width]
              for dy in range(3) for dx in range(3)]
    stacked = jnp.stack(planes, axis=-1)
    return jnp.sort(stacked, axis=-1)[:, :, 4].astype(disparity.dtype)


@functools.partial(jax.jit, static_argnames=("max_diff", "max_disparity"))
def left_right_consistency(disp_left: jnp.ndarray,
                           disp_right: jnp.ndarray,
                           max_diff: int = 1,
                           max_disparity: Optional[int] = None
                           ) -> jnp.ndarray:
    """Occlusion mask via the left-right cross check.

    A left-image pixel x with disparity d maps to right-image pixel x-d;
    it is consistent when the right disparity there agrees within
    ``max_diff``: |dL(x) - dR(x - dL(x))| <= max_diff.  Out-of-image
    projections are inconsistent.  Returns a bool [H, W] mask (True =
    consistent).

    Formulation: ``dR[y, x - dL]`` is a per-pixel dynamic gather; instead
    scan the disparity range: step d tests, for pixels with dL == d, the
    statically-shifted plane dR[y, x - d] (a dynamic_slice of a padded
    copy — the same full-range streaming pattern as the pyramid's band
    scan), a few static-trip vector compares per plane.  Out-of-image
    reads see the -2^20 pad value and can never agree within
    ``max_diff``.  Pass ``max_disparity`` to bound the scan at the
    search range; without it the scan conservatively covers every
    possible shift (the image width).
    """
    width = disp_left.shape[-1]
    d_l = disp_left.astype(jnp.int32)
    d_r = disp_right.astype(jnp.int32)
    n_planes = width if max_disparity is None else min(max_disparity, width)
    pad = [(0, 0)] * d_r.ndim
    pad[-1] = (width, 0)
    padded_r = jnp.pad(d_r, pad, constant_values=-jnp.int32(1 << 20))
    return consistency_from_padded(d_l, padded_r, pad=width,
                                   n_planes=n_planes, max_diff=max_diff)


def consistency_from_padded(d_l: jnp.ndarray, padded_r: jnp.ndarray, *,
                            pad: int, n_planes: int,
                            max_diff: int) -> jnp.ndarray:
    """Core of :func:`left_right_consistency` given a right-disparity map
    already padded with ``pad`` extra columns on the LEFT (so shifts never
    leave the array).  Out-of-image pad positions must hold a value that
    can never agree within ``max_diff`` (e.g. -2^20).  Shared with the
    2-D-tiled mesh pipeline, which fills the pad from W-neighbor halos.
    Leading (batch) dimensions broadcast through.
    """
    d_l = d_l.astype(jnp.int32)

    def plane(d, consistent):
        start = (0,) * (padded_r.ndim - 1) + (pad - d,)
        shifted = lax.dynamic_slice(padded_r, start, d_l.shape)
        hit = (d_l == d) & (jnp.abs(d_l - shifted) <= max_diff)
        return consistent | hit

    return lax.fori_loop(0, n_planes, plane, jnp.zeros_like(d_l, bool))


@jax.jit
def confidence_pkrn(cost_volume: jnp.ndarray) -> jnp.ndarray:
    """Peak-ratio (naive) confidence: (c2 - c1) / max(c2, eps) per pixel,
    where c1 <= c2 are the two smallest finite costs across disparities.

    1 means an unambiguous minimum, 0 a tie — the standard matching
    confidence used to gate downstream consumers.  +inf (invalid
    disparity) entries are ignored; pixels with fewer than two finite
    hypotheses get confidence 0.

    The two smallest values come from two masked min-sweeps over the
    D axis (instead of ``lax.top_k``, a per-pixel sort): c1 is the
    plain min; c2 re-mins with the c1 entries knocked out, except that
    a duplicated minimum makes c2 = c1 — exactly top_k's multiset
    semantics.
    """
    cost = cost_volume.astype(jnp.float32)
    cost = jnp.where(jnp.isfinite(cost), cost, jnp.inf)
    c1 = jnp.min(cost, axis=-1)
    is_min = cost == c1[..., None]
    duplicated = jnp.sum(is_min, axis=-1) > 1
    c2 = jnp.min(jnp.where(is_min, jnp.inf, cost), axis=-1)
    c2 = jnp.where(duplicated & jnp.isfinite(c1), c1, c2)
    ok = jnp.isfinite(c2)
    conf = jnp.where(ok, (c2 - c1) / jnp.maximum(c2, 1e-12), 0.0)
    return jnp.clip(conf, 0.0, 1.0)


@functools.partial(jax.jit, static_argnames=("window", "n_bins"))
def weighted_median_filter(disparity: jnp.ndarray, guide: jnp.ndarray, *,
                           window: int = 5, sigma: float = 0.1,
                           n_bins: int = 256) -> jnp.ndarray:
    """Guide-weighted median of the disparity map — the production
    edge-preserving disparity post-filter (Ma et al., "Constant Time
    Weighted Median Filtering for Stereo Matching and Beyond", ICCV'13;
    OpenCV ships it as ximgproc's disparity WLS/WMF stage).  Each output
    pixel is the weighted median of its ``window``-neighborhood, the
    weight of neighbor q being the guide-image affinity
    ``exp(-(G(q) - G(p))^2 / (2 sigma^2))`` — so smoothing never crosses
    intensity edges, where the plain median blurs disparity boundaries.

    The median is of *rounded* disparities (bins ``0..n_bins-1``, clipped)
    — apply before sub-pixel refinement, like the integer WMF in
    production stacks.  Out-of-image neighbors carry zero weight; the
    center always participates (affinity 1), so the result is defined
    everywhere.  Returns the smallest bin whose cumulative weight reaches
    half the total, in the input dtype.

    Formulation: sorting (value, weight) pairs per pixel is a gather
    fest, and a one-hot histogram (window^2 shifted planes x n_bins)
    pays O(window^2 * n_bins) vector work.  The weighted median is
    instead found by *binary search
    over bins*: it is the smallest b with W(b) = sum_q w_q [v_q <= b]
    >= total/2, and W(b) is monotone in b, so ceil(log2(n_bins)) rounds
    of a per-pixel vectorized bisection — each round one windowed
    compare-accumulate over [H, W] PLANES, no bin axis at all — pin it
    exactly.  O(window^2 * log n_bins) work, same predicate as the
    histogram-cumsum form (identical result up to f32 summation order),
    no gathers, no sorts.
    """
    r = window // 2
    bins = jnp.clip(jnp.round(disparity.astype(jnp.float32)),
                    0, n_bins - 1).astype(jnp.int32)
    g = guide.astype(jnp.float32)

    # +inf guide pad -> affinity exp(-inf) = 0: out-of-image neighbors
    # drop out of both the histogram and the total.
    g_pad = jnp.pad(g, r, constant_values=np.float32(np.inf))
    b_pad = jnp.pad(bins, r)
    return _wmf_from_padded(b_pad, g_pad, g, window=window, sigma=sigma,
                            n_bins=n_bins).astype(disparity.dtype)


def _wmf_from_padded(b_pad, g_pad, g, *, window, sigma, n_bins):
    """Weighted-median core on (window//2)-padded bin/guide planes —
    shared with the mesh pipelines, which fill the row pad from neighbor
    halos (guide pad must be +inf wherever out of image).  ``g`` is the
    unpadded center guide; returns int32 [H, W] median bins."""
    height, width = g.shape
    inv = np.float32(-0.5) / jnp.asarray(sigma, jnp.float32) ** 2
    taps = []
    total = jnp.zeros((height, width), jnp.float32)
    for dy in range(window):
        for dx in range(window):
            gq = g_pad[dy:dy + height, dx:dx + width]
            w = jnp.exp((gq - g) ** 2 * inv)
            w = jnp.where(jnp.isfinite(gq), w, 0.0)
            vq = b_pad[dy:dy + height, dx:dx + width]
            taps.append((vq, w))
            total = total + w
    half = 0.5 * total

    # Bisection on the monotone cumulative weight W(b): the invariant is
    # answer in [lo, hi]; ceil(log2(n_bins)) rounds collapse it.  The
    # center tap always carries weight 1, so half > 0 and
    # W(n_bins - 1) = total >= half — the search is always well-defined.
    lo = jnp.zeros((height, width), jnp.int32)
    hi = jnp.full((height, width), n_bins - 1, jnp.int32)
    for _ in range(max(1, (n_bins - 1).bit_length())):
        mid = (lo + hi) >> 1
        wsum = jnp.zeros((height, width), jnp.float32)
        for vq, w in taps:
            wsum = wsum + jnp.where(vq <= mid, w, 0.0)
        ge = wsum >= half
        hi = jnp.where(ge, mid, hi)
        lo = jnp.where(ge, lo, mid + 1)
    return lo


def _thomas_forward(diag, off, b, off_prev, cp0, dp0):
    """Thomas forward elimination over the LAST axis (vectorized over the
    leading axes): cp_x = off_x / (diag_x - off_prev_x cp_{x-1}),
    dp_x = (b_x - off_prev_x dp_{x-1}) / (same).  ``cp0``/``dp0`` seed
    the recurrence (zeros at a true border; the previous shard's last
    values when a mesh splits the solve axis).  Returns (cps, dps)."""
    def to_scan(x):
        return jnp.moveaxis(x, -1, 0)

    def fwd(carry, inp):
        cp_prev, dp_prev = carry
        diag_x, off_x, b_x, offp_x = inp
        denom = diag_x - offp_x * cp_prev
        cp = off_x / denom
        dp = (b_x - offp_x * dp_prev) / denom
        return (cp, dp), (cp, dp)

    _, (cps, dps) = lax.scan(fwd, (cp0, dp0),
                             (to_scan(diag), to_scan(off),
                              to_scan(b), to_scan(off_prev)))
    return jnp.moveaxis(cps, 0, -1), jnp.moveaxis(dps, 0, -1)


def _thomas_backward(cps, dps, u_next0):
    """Back substitution: v_x = dp_x - cp_x v_{x+1}, scanned in reverse
    over the last axis.  ``u_next0`` seeds from beyond the last element
    (zero at a true border — the last cp is 0 there, so the seed value
    is then irrelevant; the next shard's first solution on a mesh)."""
    def bwd(u_next, inp):
        cp, dp = inp
        u_x = dp - cp * u_next
        return u_x, u_x

    _, vs = lax.scan(bwd, u_next0,
                     (jnp.moveaxis(cps, -1, 0), jnp.moveaxis(dps, -1, 0)),
                     reverse=True)
    return jnp.moveaxis(vs, 0, -1)


def _fgs_confidence(u, confidence):
    """Data-term weights for the WLS solves.  The epsilon floor keeps an
    all-zero-confidence line from producing a singular (pure-Laplacian)
    system.  1e-3 (not denormal-tiny): the zero-confidence solve's
    condition number is ~lam/eps, and f32 loses the solution entirely
    around 2^24 — at 1e-3 the system stays well-posed while smoothing
    still outweighs the data term by ~4-5 orders, so inpainting behavior
    is unchanged.  Shared with the mesh variant (parallel/sharded.py),
    whose parity depends on the identical floor."""
    if confidence is None:
        return jnp.ones_like(u)
    return jnp.maximum(confidence.astype(jnp.float32), 1e-3)


def _fgs_lambda_schedule(lam, total, t):
    """The paper's attenuated per-round lambda, telescoping to ``lam``
    total: lam_t = 1.5 * lam * 4^(T-t) / (4^T - 1).  Shared with the
    mesh variant, whose parity depends on the identical schedule."""
    return 1.5 * lam * 4.0 ** (total - t) / (4.0 ** total - 1.0)


def _fgs_system(u, c, a_left, a_right, lam):
    """The tridiagonal normal equations of one 1-D WLS subproblem:
    returns (diag, off, b, off_prev) with ``a_left``/``a_right`` the
    smoothness weights toward x-1 / x+1 (zero beyond true borders —
    mesh callers fill the boundary entries from guide halos)."""
    diag = c + lam * (a_left + a_right)
    off = -lam * a_right                           # couples x and x+1
    off_prev = -lam * a_left                       # couples x and x-1
    return diag, off, c * u, off_prev


def _fgs_pass(u: jnp.ndarray, c: jnp.ndarray, a: jnp.ndarray,
              lam) -> jnp.ndarray:
    """One 1-D fast-global-smoother pass along the LAST axis.

    Exactly minimizes, independently per row,

        sum_x c_x (v_x - u_x)^2  +  lam * sum_x a_x (v_x - v_{x+1})^2

    whose normal equations are tridiagonal — solved by the Thomas
    algorithm as a forward-elimination ``lax.scan`` and a reversed
    back-substitution scan, both vectorized over the leading axes
    (rows ride the vector lanes; the scan axis is sequential exactly
    like the DP/SGM scans).  ``a`` has one fewer element along the last
    axis (the weight between x and x+1).
    """
    zero = jnp.zeros_like(u[..., :1])
    a_right = jnp.concatenate([a, zero], -1)       # a_x   (last = border 0)
    a_left = jnp.concatenate([zero, a], -1)        # a_{x-1}
    diag, off, b, off_prev = _fgs_system(u, c, a_left, a_right, lam)
    z = jnp.zeros_like(u[..., 0])
    cps, dps = _thomas_forward(diag, off, b, off_prev, z, z)
    return _thomas_backward(cps, dps, z)


@functools.partial(jax.jit, static_argnames=("iterations",))
def fgs_smooth(disparity: jnp.ndarray, guide: jnp.ndarray, *,
               lam: float = 128.0, sigma_color: float = 8.0,
               iterations: int = 3,
               confidence: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Fast Global Smoother (Min et al., "Fast Global Image Smoothing
    Based on Weighted Least Squares", TIP 2014) — the solver behind
    OpenCV ximgproc's ``DisparityWLSFilter``, the standard
    confidence-driven disparity post-filter.  Minimizes the WLS energy

        sum_p c_p (v_p - d_p)^2
          + lam * sum_{p~q} exp(-|G_p - G_q| / sigma_color) (v_p - v_q)^2

    approximately, by alternating exact 1-D solves along rows and
    columns for ``iterations`` rounds with the paper's attenuated
    per-round lambda  (lam_t = 1.5 * lam * 4^{T-t} / (4^T - 1)),
    which telescopes to an effective total of ``lam``.

    ``confidence`` (e.g. the LR consistency mask, or PKRN) weights the
    data term: c_p = 0 pixels carry no data and are inpainted from
    their neighbors along the smoothing paths — exactly how the WLS
    filter fills occlusions.  ``sigma_color`` is in guide intensity
    units (~8 for 8-bit-range guides).  Returns float32.

    Formulation: each 1-D subproblem is a tridiagonal solve — two
    ``lax.scan`` sweeps with [rows]-vectorized carries, the same
    sequential-scan-over-vectorized-rows shape as the DP reducer; no
    gathers, no iteration to a fixpoint, no sparse solver.
    """
    u = disparity.astype(jnp.float32)
    g = guide.astype(jnp.float32)
    c = _fgs_confidence(u, confidence)
    inv_sigma = np.float32(-1.0) / jnp.asarray(sigma_color, jnp.float32)
    a_h = jnp.exp(jnp.abs(g[..., :, 1:] - g[..., :, :-1]) * inv_sigma)
    a_v = jnp.exp(jnp.abs(g[..., 1:, :] - g[..., :-1, :]) * inv_sigma)

    lam = jnp.asarray(lam, jnp.float32)
    total = iterations
    for t in range(1, total + 1):
        lam_t = _fgs_lambda_schedule(lam, total, t)
        u = _fgs_pass(u, c, a_h, lam_t)
        u = jnp.swapaxes(_fgs_pass(jnp.swapaxes(u, -1, -2),
                                   jnp.swapaxes(c, -1, -2),
                                   jnp.swapaxes(a_v, -1, -2), lam_t),
                         -1, -2)
    return u


@functools.partial(jax.jit, static_argnames=("max_diff", "window",
                                             "min_frac"))
def speckle_mask(disparity: jnp.ndarray, *, max_diff: float = 1.0,
                 window: int = 9, min_frac: float = 0.25) -> jnp.ndarray:
    """Support mask for speckle suppression: True where enough of the
    surrounding window agrees with the pixel's disparity.

    ``support(p) = #{q in window(p) : |d(q) - d(p)| <= max_diff}`` over
    in-image neighbors; the pixel is kept when
    ``support >= ceil(min_frac * n_in_image_window)``.  A small isolated
    blob of outlier disparities ("speckle" — the classic mismatch
    artifact of local WTA) finds little agreeing support and is masked;
    coherent surfaces keep near-full support.  Normalizing by the
    in-image window count keeps the criterion fair at borders/corners.

    Formulation: the region-growing speckle filters of CPU stereo
    stacks (flood-fill connected components, then a size threshold) are
    pointer-chasing and data-dependent — hostile to XLA.  This windowed
    support test is ``window**2`` shifted compare-accumulates on the
    [H, W] plane (the same shifted-plane pattern as the median filter):
    one fused elementwise pass, no gathers, no iteration to a fixpoint.
    It approximates the region-size test: any region is "supported" only
    through window-local agreement, so thin or small regions (below the
    window scale) lose their pixels while large coherent ones do not.
    Note the comparison is against the *center* disparity, so surfaces
    steeper than ``max_diff``/pixel also lose support — choose
    ``max_diff`` at least the expected slope times window radius, or
    gate on the mask only where confidence is low.
    """
    r = window // 2
    d = disparity.astype(jnp.float32)
    padded = jnp.pad(d, r, mode="constant", constant_values=jnp.nan)
    return _windowed_support(padded, d, max_diff=max_diff, window=window,
                             min_frac=min_frac)


def _windowed_support(padded, center, *, max_diff, window, min_frac):
    """Support test given a NaN-padded (+window//2 per side) plane —
    shared by the single-chip mask and the halo-padded mesh variant
    (parallel/sharded.py feeds neighbor-row halos with NaN ring edges)."""
    height, width = center.shape
    similar = jnp.zeros((height, width), jnp.int32)
    n_in = jnp.zeros((height, width), jnp.int32)
    for dy in range(window):
        for dx in range(window):
            shifted = padded[dy:dy + height, dx:dx + width]
            inside = ~jnp.isnan(shifted)
            similar += jnp.where(jnp.abs(shifted - center) <= max_diff, 1, 0)
            n_in += inside.astype(jnp.int32)
    need = jnp.ceil(min_frac * n_in.astype(jnp.float32)).astype(jnp.int32)
    return similar >= need


@functools.partial(jax.jit, static_argnames=("max_diff", "window",
                                             "min_frac", "fill"))
def filter_speckles(disparity: jnp.ndarray, *, max_diff: float = 1.0,
                    window: int = 9, min_frac: float = 0.25,
                    fill: str = "zero",
                    invalid_value: float = 0) -> jnp.ndarray:
    """Suppress speckles: replace pixels failing :func:`speckle_mask`.

    ``fill="zero"`` writes ``invalid_value`` (0 = the Middlebury unknown
    convention, composing with downstream validity masks);
    ``fill="background"`` extends the nearest supported disparity from
    the left/right along the scanline, taking the smaller (background)
    side — the same rule as occlusion filling.
    """
    mask = speckle_mask(disparity, max_diff=max_diff, window=window,
                        min_frac=min_frac)
    if fill == "zero":
        out = jnp.where(mask, disparity,
                        jnp.asarray(invalid_value, disparity.dtype))
        return out
    if fill == "background":
        return fill_inconsistent(disparity, mask).astype(
            jnp.promote_types(disparity.dtype, jnp.float32))
    raise ValueError(f"unknown fill mode: {fill!r}")


def right_disparity(pipeline_fn, left: jnp.ndarray,
                    right: jnp.ndarray) -> jnp.ndarray:
    """Right-image disparity from a left-disparity pipeline.

    Right-to-left matching is left-to-right matching on horizontally
    mirrored images: estimate on (flip(right), flip(left)) and flip the
    result back.  ``pipeline_fn(left, right) -> disparity``.
    """
    return pipeline_fn(jnp.asarray(right)[:, ::-1],
                       jnp.asarray(left)[:, ::-1])[:, ::-1]


@jax.jit
def right_volume_from_left(cost_volume: jnp.ndarray) -> jnp.ndarray:
    """Re-index a left-view cost volume into the right view.

    Matching right pixel x against left pixel x + d scores the same pair
    of windows as matching left pixel x + d against right pixel x, so

        C_R[y, x, d] = C_L[y, x + d, d]        (x + d >= W -> +inf)

    — the trick OpenCV's SGBM uses to get a right disparity (and thus a
    left-right occlusion check) from the volume it already has, instead
    of paying for a second full cost + aggregation run.  Applied to an
    *aggregated* volume the result is an approximation of true
    right-image aggregation (the smoothing paths followed left-image
    geometry), which is exactly the approximation production SGBM makes.

    Formulation: the diagonal re-index is a per-pixel gather in
    general, but per disparity plane it is a static W-shift — so stream
    the D planes with ``dynamic_slice`` starts at (0, d, d) on a +inf
    right-padded copy, the same full-range plane-scan pattern as
    :func:`left_right_consistency`.  No gathers, 2x-volume traffic.
    """
    max_disp = cost_volume.shape[-1]
    inf = jnp.asarray(jnp.inf, cost_volume.dtype)
    pad = [(0, 0)] * cost_volume.ndim
    pad[-2] = (0, max_disp)
    padded = jnp.pad(cost_volume, pad, constant_values=inf)
    return right_volume_from_padded(padded, width=cost_volume.shape[-2])


def right_volume_from_padded(padded: jnp.ndarray,
                             width: int) -> jnp.ndarray:
    """Core of :func:`right_volume_from_left` given a volume already
    extended on the RIGHT of the W axis by (at least) D - 1 columns —
    +inf where beyond the true image, real neighbor data under the
    2-D-tiled mesh (which shares this).  Returns the [..., width, D]
    right-view volume; leading (batch) dimensions broadcast through.
    """
    max_disp = padded.shape[-1]
    lead = padded.shape[:-2]
    # full_like of a slice (not a fresh constant): keeps the loop carry's
    # shard_map varying type consistent with the body (the vma rule —
    # see fill_inconsistent).
    out = jnp.full_like(padded[..., :width, :], jnp.inf)

    def plane(d, out):
        start = (0,) * len(lead) + (d, d)
        sl = lax.dynamic_slice(padded, start, lead + (width, 1))
        return lax.dynamic_update_slice(out, sl,
                                        (0,) * len(lead) + (0, d))

    return lax.fori_loop(0, max_disp, plane, out)


@jax.jit
def right_disparity_from_volume(cost_volume: jnp.ndarray) -> jnp.ndarray:
    """WTA right disparity from the left volume via
    :func:`right_volume_from_left` — the cheap LR-check companion
    (lowest-d tie semantics, matching ops.disparity.winner_takes_all)."""
    return jnp.argmin(right_volume_from_left(cost_volume),
                      axis=2).astype(jnp.int32)


def fill_inconsistent(disparity: jnp.ndarray,
                      mask: jnp.ndarray) -> jnp.ndarray:
    """Fill masked-out (occluded) pixels with the standard occlusion fill:
    the SMALLER of the nearest consistent disparities to the left and
    right (occluded pixels belong to the background, which has the lower
    disparity).  Implemented as a pair of prefix scans along W; a side
    with no consistent neighbor defers to the other, and a fully
    inconsistent row keeps its original values.
    """
    d = disparity.astype(jnp.float32)
    valid = mask.astype(bool)

    left_fill = propagate_last_valid(d, valid)
    right_fill = propagate_last_valid(d[..., ::-1], valid[..., ::-1])[..., ::-1]

    fill = jnp.fmin(left_fill, right_fill)  # fmin ignores NaN sides
    filled = jnp.where(valid, d, fill)
    return jnp.where(jnp.isnan(filled), d, filled)


def propagate_last_valid(vals: jnp.ndarray, ok: jnp.ndarray) -> jnp.ndarray:
    """Per row, the last valid value at or left of each position along the
    final axis (NaN where none yet) — the occlusion fill's prefix scan,
    shared with the 2-D-tiled mesh variant (which stitches the NaN prefix
    with a cross-tile carry).  Leading dimensions broadcast through.
    """
    def step(carry, inp):
        v, o = inp
        carry = jnp.where(o, v, carry)
        return carry, carry
    # full_like (not a fresh constant) keeps the carry's shard_map
    # varying type stable when this runs inside a mesh program.
    init = jnp.full_like(vals[..., 0], jnp.nan)
    _, out = lax.scan(step, init, (jnp.moveaxis(vals, -1, 0),
                                   jnp.moveaxis(ok, -1, 0)))
    return jnp.moveaxis(out, 0, -1)
