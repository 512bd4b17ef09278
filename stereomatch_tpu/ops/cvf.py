"""Guided-filter cost-volume aggregation (functional, jittable).

A second aggregation family alongside SGM: edge-aware *local* smoothing
of the cost volume by guided image filtering (He et al. 2010), applied
per disparity slice with the left image as the guide — the "cost volume
filtering" method of Hosni et al. (PAMI 2013).  This has no analogue in
the reference (its only aggregation is semiglobal,
stereomatch/aggregation.py:12-57); it is beyond-parity capability.

Why it earns its place: the whole method is box filters and
elementwise algebra over the [H, W, D] volume — no sequential scans at
all, so unlike SGM it has no recurrence to serialize, trivially
vectorizes over the disparity axis, and shards over image tiles
with plain halos (no carry hand-off, no direction families).  It is the
low-latency quality/speed point between raw WTA and full SGM.

Semantics:

* Windows are symmetric ``(2r+1) x (2r+1)`` boxes, clipped at the image
  border, every mean normalized by the count actually inside (the
  published guided-filter convention; note this differs from the SSD
  cost window, which mirrors the reference's half-open ``[i-k, i+k)``).
* Non-finite cost entries (the ``+inf`` fill of the ``d > column``
  wedge, ssd.cu:58-60) are excluded from every window statistic via a
  validity mask and restored as ``+inf`` in the output, so downstream
  WTA/DP see the same invalid-disparity contract as with SGM.  On an
  all-finite volume the masked form reduces exactly to the standard
  guided filter (``assume_finite=True`` skips the mask work — correct
  for census/Birchfield volumes, which have no infinite entries).
* Storage dtype is preserved: bfloat16 volumes stream in/out as bf16
  while all statistics are computed in float32 (the repo-wide
  widen-on-load discipline).
* ``subsample=s`` > 1 switches to the Fast Guided Filter (He & Sun
  2015): all window statistics are computed on an s x-downsampled grid
  (bilinear ``jax.image.resize`` both ways) and the per-window linear model is bilinearly upsampled
  before the final ``q = a*I + b``.  The box-filter arithmetic — the
  dominant cost at full resolution, ~2*(2r+1) adds per element per
  statistic — shrinks by s^2 while edges stay sharp because the model
  is still applied against the FULL-resolution guide.  Approximate by
  construction (published quality is near-indistinguishable for
  s <= r/2); ``subsample=1`` is the exact path, bit-identical to the
  default.  Single-chip/streaming only: the partitioners run the exact
  filter (low-res grid alignment does not tile bit-exactly).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


def _box_sum_sym(x: jnp.ndarray, radius: int, axes=(0, 1)) -> jnp.ndarray:
    """Separable clipped box sum over a symmetric (2r+1) window.

    Out-of-image taps contribute zero (additive identity), which is the
    window-clipping semantic once sums are normalized by the in-image
    tap count.  One ``reduce_window`` per axis.
    """
    for ax in axes:
        window = [1] * x.ndim
        padding = [(0, 0)] * x.ndim
        window[ax] = 2 * radius + 1
        padding[ax] = (radius, radius)
        x = lax.reduce_window(x, jnp.zeros((), x.dtype), lax.add,
                              window_dimensions=tuple(window),
                              window_strides=(1,) * x.ndim,
                              padding=tuple(padding))
    return x


def _linear_model(mean_p, mean_i, corr_ip, corr_ii, eps):
    """Per-window linear model from windowed means: q ~= a*I + b."""
    var_i = jnp.maximum(corr_ii - mean_i * mean_i, 0.0)
    cov_ip = corr_ip - mean_i * mean_p
    a = cov_ip / (var_i + jnp.float32(eps))
    b = mean_p - a * mean_i
    return a, b


def _prefix_planes_w(plane: jnp.ndarray, radius: int):
    """Shifted W-prefix planes of an [H, W] plane.

    Returns (hi, lo, p) with ``p[y, k] = sum_{x < k} plane[y, x]`` (the
    zero-prepended prefix, [H, W+1]), ``hi[y, x] = p[y, min(x+r+1, W)]``
    and ``lo[y, x] = p[y, max(x-r, 0)]`` — so ``hi - lo`` is the clipped
    symmetric W box sum.  Planes are [H, W]-sized: cheap next to the
    volume (the point of the wedge path below).
    """
    h, w = plane.shape
    p = jnp.concatenate([jnp.zeros((h, 1), plane.dtype),
                         jnp.cumsum(plane, axis=1)], axis=1)
    hi = jnp.pad(p, ((0, 0), (0, radius)),
                 mode="edge")[:, radius + 1:radius + 1 + w]
    lo = jnp.pad(p, ((0, 0), (radius, 0)), mode="edge")[:, :w]
    return hi, lo, p


def _filter_body_wedge(volume, guide, radius, eps, wedge_offset):
    """Masked guided filter when the invalid set is the STATIC wedge
    ``x < d + wedge_offset`` (the standard SSD/SAD invalid structure,
    ssd.cu:58-60) — same masked-mean semantics as ``_filter_body`` with
    ``finite = (x >= d + offset)``, restructured around the wedge being
    independent of the row:

    * ``box(valid)`` collapses to the closed form
      ``countH[y] * cntW[x, d]`` (no volume passes);
    * ``box(guide * valid)`` and ``box(guide^2 * valid)`` collapse to
      elementwise reconstructions from [H, W] prefix planes of
      ``boxH(guide)`` — the clipped window's masked lower bound
      ``max(x - r, d + offset)`` is either the d-independent shifted
      plane or the x-independent prefix column, selected by one
      ``where`` (the ZNCC plane-algebra trick, ops/cost.py);
    * only 4 genuine volume statistics remain (p0, g*p0, a, b — 8
      separable box passes instead of 14).

    Exactness: same masked means, different association — within
    ~2e-6 rel of ``_filter_body`` (probe check), NOT bit-identical.
    """
    h, w = guide.shape
    d = volume.shape[2]
    r = radius
    box = functools.partial(_box_sum_sym, radius=r)

    x_id = lax.broadcasted_iota(jnp.int32, (w, d), 0)
    d_id = lax.broadcasted_iota(jnp.int32, (w, d), 1) + wedge_offset
    valid_wd = x_id >= d_id                                  # [W, D]

    p32 = volume.astype(jnp.float32)
    i32 = guide.astype(jnp.float32)
    g = i32[:, :, None]
    p0 = jnp.where(valid_wd[None], p32, 0.0)

    s_p = box(p0)                                            # 2 vol passes
    s_gp = box(g * p0)                                       # 2 vol passes

    # Guide statistics from [H, W] planes + elementwise reconstruction.
    g1 = _box_sum_sym(i32, r, axes=(0,))
    g2 = _box_sum_sym(i32 * i32, r, axes=(0,))
    hi1, lo1, p1 = _prefix_planes_w(g1, r)
    hi2, lo2, p2 = _prefix_planes_w(g2, r)
    # Pd[y, dd] = P[y, clip(dd + offset, 0, W)]: contiguous prefix
    # columns (edge-pad if offset + D overruns) — a static slice, not a
    # gather.
    lo_col = max(0, min(wedge_offset, w))
    overrun = max(0, lo_col + d - (w + 1))
    p1e = jnp.pad(p1, ((0, 0), (0, overrun)), mode="edge")
    p2e = jnp.pad(p2, ((0, 0), (0, overrun)), mode="edge")
    pd1 = lax.slice_in_dim(p1e, lo_col, lo_col + d, axis=1)  # [H, D]
    pd2 = lax.slice_in_dim(p2e, lo_col, lo_col + d, axis=1)
    cond = (x_id - r) >= d_id                                # [W, D]
    s_g = hi1[:, :, None] - jnp.where(cond[None], lo1[:, :, None],
                                      pd1[:, None, :])
    s_gg = hi2[:, :, None] - jnp.where(cond[None], lo2[:, :, None],
                                       pd2[:, None, :])

    y_id = jnp.arange(h)
    count_h = (jnp.minimum(y_id + r, h - 1)
               - jnp.maximum(y_id - r, 0) + 1).astype(jnp.float32)
    cnt_w = jnp.maximum(
        jnp.minimum(x_id + r, w - 1)
        - jnp.maximum(jnp.maximum(x_id - r, 0), d_id) + 1, 0
    ).astype(jnp.float32)                                    # [W, D]
    count = jnp.maximum(count_h[:, None, None] * cnt_w[None], 1.0)

    a, b = _linear_model(s_p / count, s_g / count, s_gp / count,
                         s_gg / count, eps)
    a0 = jnp.where(valid_wd[None], a, 0.0)
    b0 = jnp.where(valid_wd[None], b, 0.0)
    q = (box(a0) / count) * g + box(b0) / count              # 4 vol passes
    return jnp.where(valid_wd[None], q,
                     jnp.float32(jnp.inf)).astype(volume.dtype)


def _filter_stats(p32, i32, radius, eps, assume_finite):
    """First guided-filter stage: per-window linear model (a, b).

    Every volume-shaped statistic gets its OWN box call.  Rounds 1-2
    stacked them on the D axis to "save materializations" (the old ZNCC
    idiom), but XLA fuses each elementwise producer (``guide * p0``
    etc.) straight INTO its ``reduce_window``, while a ``concatenate``
    materializes every operand first — separate calls are bit-identical
    (windows span only (H, W); slices independent).

    Returns (a, b, finite, box, count): ``finite`` is the validity mask
    (None when assume_finite); ``count`` is the normalizer the second
    stage reuses (stage 2's window-count statistic is the same
    ``box(valid)`` — no recompute).
    """
    box = functools.partial(_box_sum_sym, radius=radius)
    guide = i32[:, :, None]

    if assume_finite:
        finite = None
        ones = jnp.ones(p32.shape[:2], jnp.float32)
        count = box(ones)[:, :, None]                      # [H, W, 1]
        mean_p = box(p32) / count
        corr_ip = box(guide * p32) / count
        # Guide-only stats are [H, W] — negligible beside the volume.
        mean_i = (box(i32) / count[:, :, 0])[:, :, None]
        corr_ii = (box(i32 * i32) / count[:, :, 0])[:, :, None]
    else:
        finite = jnp.isfinite(p32)
        valid = finite.astype(jnp.float32)                 # [H, W, D]
        p0 = jnp.where(finite, p32, 0.0)
        count = jnp.maximum(box(valid), 1.0)               # guard 0/0 —
        # zero-valid windows exist only deep inside the invalid wedge,
        # whose cells are restored to +inf by the caller anyway.
        mean_p = box(p0) / count
        mean_i = box(guide * valid) / count
        corr_ip = box(guide * p0) / count
        corr_ii = box(guide * guide * valid) / count

    a, b = _linear_model(mean_p, mean_i, corr_ip, corr_ii, eps)
    return a, b, finite, box, count


def _resize2d(x, height, width):
    """Bilinear resize over the two leading (spatial) axes."""
    return jax.image.resize(x, (height, width) + x.shape[2:], "bilinear")


def _filter_body_fast(volume, guide, radius, eps, assume_finite,
                      subsample):
    """Fast Guided Filter: statistics on an s x-downsampled grid.

    The masked form downsamples the zeroed volume and the validity mask
    with the SAME bilinear kernel, so their ratio is a kernel-weighted
    masked mean; low-res windows whose pooled validity underflows are
    guarded exactly like empty windows in the exact path.  The +inf
    invalid cells are restored from the FULL-resolution mask.
    """
    s = subsample
    height, width = guide.shape
    lh, lw = max(1, height // s), max(1, width // s)
    p32 = volume.astype(jnp.float32)
    i32 = guide.astype(jnp.float32)
    low_r = max(1, radius // s)

    i_low = _resize2d(i32, lh, lw)
    if assume_finite:
        p_low = _resize2d(p32, lh, lw)
        finite = None
        a, b, _, box, count = _filter_stats(p_low, i_low, low_r, eps, True)
        a_bar = box(a) / count
        b_bar = box(b) / count
    else:
        finite = jnp.isfinite(p32)
        valid = finite.astype(jnp.float32)
        p0 = jnp.where(finite, p32, 0.0)
        # One resize for both pooled quantities (lanes independent), then
        # the masked stats treat the pooled validity as fractional
        # counts: the zeroed volume already carries the weight, and
        # near-zero pooled validity is guarded like empty windows in the
        # exact path (1e-6 floor: pooled counts are fractional).
        ndisp = p32.shape[2]
        low = _resize2d(jnp.concatenate([p0, valid], axis=2), lh, lw)
        p_low, v_low = low[:, :, :ndisp], low[:, :, ndisp:]
        box = functools.partial(_box_sum_sym, radius=low_r)
        g_low = i_low[:, :, None]
        count = jnp.maximum(box(v_low), jnp.float32(1e-6))
        a, b = _linear_model(box(p_low) / count,
                             box(g_low * v_low) / count,
                             box(g_low * p_low) / count,
                             box(g_low * g_low * v_low) / count, eps)
        a_bar = box(a * v_low) / count
        b_bar = box(b * v_low) / count

    a_full = _resize2d(a_bar, height, width)
    b_full = _resize2d(b_bar, height, width)
    q = a_full * i32[:, :, None] + b_full
    if finite is not None:
        q = jnp.where(finite, q, jnp.float32(jnp.inf))
    return q.astype(volume.dtype)


def _filter_body(volume, guide, radius, eps, assume_finite, subsample=1,
                 wedge_offset=None):
    # Trace-time checks shared by both entry points (the CLIs take bare
    # int/float flags; fail with a clear message, not a reduce_window
    # shape error or an inf/NaN division at runtime).
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    if not eps > 0:
        raise ValueError(f"eps must be > 0, got {eps} (zero divides by "
                         "the variance of constant-guide windows)")
    if subsample < 1:
        raise ValueError(f"subsample must be >= 1, got {subsample}")
    if wedge_offset is not None:
        if assume_finite:
            raise ValueError("wedge_offset and assume_finite are mutually "
                             "exclusive (a wedge volume is not finite)")
        if subsample > 1:
            raise ValueError("wedge_offset does not compose with the "
                             "subsampled fast path (use one or the other)")
        if wedge_offset < 0:
            raise ValueError(f"wedge_offset must be >= 0, got "
                             f"{wedge_offset}")
        return _filter_body_wedge(volume, guide, radius, eps,
                                  int(wedge_offset))
    if subsample > 1:
        return _filter_body_fast(volume, guide, radius, eps,
                                 assume_finite, subsample)
    p32 = volume.astype(jnp.float32)
    i32 = guide.astype(jnp.float32)
    a, b, finite, box, count = _filter_stats(p32, i32, radius, eps,
                                             assume_finite)

    # Second stage: each output pixel averages the linear models of every
    # window that contains it.  Under masking only windows centered at a
    # valid cell contribute (their (a, b) describe real data); on finite
    # volumes this is the plain box mean of the standard algorithm.
    # ``count`` from stage 1 IS stage 2's normalizer (same box(valid)).
    if finite is None:
        q = (box(a) / count) * i32[:, :, None] + box(b) / count
    else:
        valid = finite.astype(jnp.float32)
        q = ((box(a * valid) / count) * i32[:, :, None]
             + box(b * valid) / count)
        q = jnp.where(finite, q, jnp.float32(jnp.inf))
    return q.astype(volume.dtype)


@functools.partial(jax.jit,
                   static_argnames=("radius", "eps", "assume_finite",
                                    "subsample", "wedge_offset"))
def guided_filter_aggregate(cost_volume: jnp.ndarray, guide: jnp.ndarray,
                            *, radius: int = 8, eps: float = 1e-4,
                            assume_finite: bool = False,
                            subsample: int = 1,
                            wedge_offset=None) -> jnp.ndarray:
    """Edge-aware local aggregation: guided-filter each disparity slice.

    Args:
        cost_volume: [H, W, D] matching costs (float32/bfloat16; +inf
          marks invalid disparities and survives the filter).
        guide: [H, W] left image (the edge structure the smoothing
          respects — disparity boundaries in stereo follow image edges).
        radius: window half-size; the smoothing support is
          (2*radius+1)^2 (second stage doubles the effective reach).
        eps: edge-stop regularizer — larger blurs across weaker edges
          (the guided-filter epsilon; scale is image-intensity^2, so
          1e-4 suits [0, 1]-normalized images).
        assume_finite: skip the validity-mask plumbing (exact only when
          the volume has no non-finite entries, e.g. census/Birchfield).
        subsample: > 1 enables the Fast Guided Filter — window
          statistics on an s x-downsampled grid (box arithmetic shrinks
          by s^2; the model still applies against the full-res guide).
          Approximate; 1 (default) is the exact filter.
        wedge_offset: when the caller KNOWS the volume's only invalid
          entries are the standard wedge ``x < d + wedge_offset``
          (SSD/SAD/Birchfield volumes — the cost producer's
          disparity_offset), pass it here: the three masked guide
          statistics collapse from volume box passes to [H, W]
          prefix-plane algebra (see _filter_body_wedge).  Same
          masked-mean semantics to ~2e-6 rel; the volume's actual +inf
          pattern MUST equal the wedge.
    """
    if cost_volume.ndim != 3:
        raise ValueError(f"cost_volume must be [H, W, D], got "
                         f"{cost_volume.shape}")
    if guide.shape != cost_volume.shape[:2]:
        raise ValueError(f"guide {guide.shape} does not match volume "
                         f"spatial dims {cost_volume.shape[:2]}")
    return _filter_body(cost_volume, guide, int(radius), float(eps),
                        bool(assume_finite), int(subsample),
                        wedge_offset=wedge_offset)


def guided_filter_from_padded(volume_padded: jnp.ndarray,
                              guide_padded: jnp.ndarray,
                              pad_before: int, pad_after: int,
                              *, radius: int = 8, eps: float = 1e-4,
                              assume_finite: bool = False) -> jnp.ndarray:
    """Row-sharded body: filter a tile carrying halo rows, crop the halo.

    Both filter stages are box means, so the output at row y depends on
    input rows [y - 2*radius, y + 2*radius]; with ``pad_*`` >= 2*radius
    halo rows from the neighboring tiles (zero rows beyond the global
    image edge, where windows clip anyway) the cropped interior is
    bit-identical to the unsharded filter — this is what the sharded
    parity tests assert.  Ragged halos (first/last tile) are fine: the
    caller passes the rows that exist and the clipped-count
    normalization handles the rest, PROVIDED out-of-image pad rows are
    marked invalid.  With ``assume_finite`` there is no mask to mark
    them with, so callers must pass exactly the existing rows
    (pad_before = 0 on the first tile, etc.), which the halo helpers'
    ring-end zero fill does not guarantee — the sharded layer therefore
    always uses the masked path and poisons out-of-image halo rows to
    +inf instead.
    """
    out = _filter_body(volume_padded, guide_padded, int(radius),
                       float(eps), bool(assume_finite))
    height = out.shape[0] - pad_before - pad_after
    return lax.dynamic_slice_in_dim(out, pad_before, height, axis=0)
