"""Cost-volume construction kernels (functional, jittable).

Array-level re-design of the reference CUDA cost kernels:

* SSD   — reference ``src/ssd.cu:15-81`` recomputes a k^2 window per
  (pixel, disparity): O(H*W*D*k^2) scalar MACs.  Here the squared-difference
  volume ``diff2[h, w, d] = (L[h, w] - R[h, w - d])^2`` is built once as a
  vectorized [H, W, D] array (disparity innermost) and the window
  sum becomes a *separable* box filter — two 1-D ``lax.reduce_window`` passes
  — O(H*W*D*k).  Direct windowed summation keeps float32 exactness (no
  integral-image cancellation).

* Birchfield–Tomasi — reference ``src/birchfield_cost.cu:70-140`` (the CUDA
  variant, which stages zero-padded scanlines in shared memory).  The
  sampling-insensitive per-pixel match cost is vectorized over [H, W, D] and
  the +/-4 scanline window becomes a 1-D box filter along W.

Semantics matched to the reference:
  - window extents are *clipped*, not normalized: rows [r-k, r+k) and columns
    [max(c-k, d), min(c+k, W))  (ssd.cu:37-42; clipping to ``max(c-k, d)`` is
    realised here by zero-masking diff2 where w < d before the box sum);
  - cost at disparities d > c is +infinity (ssd.cu:58-60);
  - Birchfield window: p in [max(d, x-K), min(W, x+K)), K=4, with zero-valued
    one-pixel borders on each scanline (birchfield_cost.cu:95-100).

Deviation (documented): the reference's Birchfield kernel leaves cells with
d > x *uninitialized* (it only writes d < min(D, x+1), birchfield_cost.cu:105)
because the output comes from ``torch.empty``.  Here they are filled with
+infinity, consistent with the SSD kernel's empty_value, so downstream
reducers never select an invalid disparity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


def _inf_value(dtype) -> jnp.ndarray:
    """+infinity for float dtypes, max value for integer dtypes.

    Mirrors NumericLimits<T>::infinity() (include/stereomatch/numeric.hpp:12-50).
    """
    dtype = jnp.dtype(dtype)
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.array(jnp.inf, dtype=dtype)
    return jnp.array(jnp.iinfo(dtype).max, dtype=dtype)


def _compute_dtype(image_dtype, cost_dtype):
    """Accumulation dtype for the cost sums."""
    cost_dtype = jnp.dtype(cost_dtype)
    if jnp.issubdtype(cost_dtype, jnp.floating):
        return jnp.float32
    return jnp.int32


def shifted_right_stack(right: jnp.ndarray, max_disparity: int,
                        disparity_offset=0) -> jnp.ndarray:
    """Build S[h, w, d] = right[h, w - (d + offset)] (zero out of range).

    One vectorized gather with a clamped index, d innermost.  This is the
    array equivalent of each CUDA thread reading
    ``right_image[krow][kcol - disp]`` (ssd.cu:49).  ``disparity_offset``
    (may be traced) selects a block of the disparity axis — the
    disparity-sharded pipeline gives each chip its own block.
    """
    width = right.shape[1]
    w_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 0)
    d_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 1)
    src = w_idx - d_idx - disparity_offset       # [W, D]
    valid = src >= 0
    gathered = jnp.take(right, jnp.maximum(src, 0), axis=1)  # [H, W, D]
    return jnp.where(valid[None, :, :], gathered, jnp.zeros((), right.dtype))


def _box_sum(volume: jnp.ndarray, kernel_size: int,
             axes: tuple) -> jnp.ndarray:
    """Separable clipped box sum with the reference's half-open window.

    The reference window along an axis is [i - k, i + k) — 2k taps
    (ssd.cu:37-42) — realised with asymmetric padding (k, k-1).  Values
    outside the array contribute zero, which matches window *clipping*
    because the summand is non-negative and the pad is additive identity.
    One ``reduce_window`` per axis (O(k) adds/element, additive-identity
    padding; exact for integer dtypes).
    """
    k = kernel_size
    for ax in axes:
        window = [1] * volume.ndim
        padding = [(0, 0)] * volume.ndim
        window[ax] = 2 * k
        padding[ax] = (k, k - 1)
        volume = lax.reduce_window(
            volume,
            jnp.zeros((), volume.dtype),
            lax.add,
            window_dimensions=tuple(window),
            window_strides=(1,) * volume.ndim,
            padding=tuple(padding),
        )
    return volume


def _diff_cost_volume(left: jnp.ndarray, right: jnp.ndarray, *,
                      max_disparity: int, kernel_size: int,
                      cost_dtype, disparity_offset,
                      absolute: bool) -> jnp.ndarray:
    """Shared body of the SSD / SAD windowed-difference cost volumes."""
    compute_dtype = _compute_dtype(left.dtype, cost_dtype)
    left_c = left.astype(compute_dtype)
    right_c = right.astype(compute_dtype)

    shifted = shifted_right_stack(right_c, max_disparity,
                                  disparity_offset)          # [H, W, D]
    diff = left_c[:, :, None] - shifted
    term = jnp.abs(diff) if absolute else diff * diff

    # Zero out w < d so the box window's lower column bound becomes
    # max(c - k, d), matching ssd.cu:40-42.
    width = left.shape[1]
    w_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 0)
    d_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 1)
    valid = (w_idx >= d_idx + disparity_offset)[None, :, :]
    term = jnp.where(valid, term, jnp.zeros((), compute_dtype))

    cost = _box_sum(term, kernel_size, axes=(0, 1))

    cost = jnp.where(valid, cost.astype(cost_dtype), _inf_value(cost_dtype))
    return cost


@functools.partial(jax.jit, static_argnames=("max_disparity", "kernel_size",
                                             "cost_dtype"))
def ssd_cost_volume(left: jnp.ndarray, right: jnp.ndarray, *,
                    max_disparity: int, kernel_size: int = 7,
                    cost_dtype=jnp.float32,
                    disparity_offset=0) -> jnp.ndarray:
    """Sum-of-squared-differences cost volume [H, W, D].

    Equivalent to CostOps::ComputeSSD (src/ssd.cu:64-81): for each pixel and
    disparity d <= c, the sum over the clipped window of
    (L[r, c] - R[r, c - d])^2; +inf (or int max) where d > c.

    ``disparity_offset`` (static or traced) computes the block
    [offset, offset + max_disparity) of a larger disparity axis — the
    building block for disparity-sharded execution.
    """
    return _diff_cost_volume(left, right, max_disparity=max_disparity,
                             kernel_size=kernel_size, cost_dtype=cost_dtype,
                             disparity_offset=disparity_offset,
                             absolute=False)


@functools.partial(jax.jit, static_argnames=("max_disparity", "kernel_size",
                                             "cost_dtype"))
def sad_cost_volume(left: jnp.ndarray, right: jnp.ndarray, *,
                    max_disparity: int, kernel_size: int = 7,
                    cost_dtype=jnp.float32,
                    disparity_offset=0) -> jnp.ndarray:
    """Sum-of-absolute-differences cost volume [H, W, D].

    Beyond the reference's cost surface (its windowed cost is SSD only,
    src/ssd.cu): identical window/validity semantics — clipped [i-k, i+k)
    windows, +inf (int max) where d > c — with an L1 summand, which is
    less sensitive to outlier pixels than the squared difference and
    cheaper on integer inputs (no squaring overflow: uint8 inputs cover
    a 14x14 window at D=256 within int32 trivially).
    """
    return _diff_cost_volume(left, right, max_disparity=max_disparity,
                             kernel_size=kernel_size, cost_dtype=cost_dtype,
                             disparity_offset=disparity_offset,
                             absolute=True)


def _diff_cost_from_padded(left_padded: jnp.ndarray,
                           right_padded: jnp.ndarray,
                           *, pad_before: int, pad_after: int,
                           max_disparity: int, kernel_size: int,
                           cost_dtype, absolute: bool) -> jnp.ndarray:
    """Shared body of the halo-consuming SSD / SAD band costs."""
    k = kernel_size
    if pad_before > k or pad_after > k - 1:
        raise ValueError("halos wider than the window change the semantics")
    compute_dtype = _compute_dtype(left_padded.dtype, cost_dtype)
    left_c = left_padded.astype(compute_dtype)
    right_c = right_padded.astype(compute_dtype)

    shifted = shifted_right_stack(right_c, max_disparity)    # [Hp, W, D]
    diff = left_c[:, :, None] - shifted
    term = jnp.abs(diff) if absolute else diff * diff

    width = left_padded.shape[1]
    w_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 0)
    d_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 1)
    valid = (w_idx >= d_idx)[None, :, :]
    term = jnp.where(valid, term, jnp.zeros((), compute_dtype))

    # W-axis clipped window as usual; H-axis window consumes the explicit
    # halos: pad only the part of (k, k-1) the caller did not provide.
    cost = lax.reduce_window(
        term,
        jnp.zeros((), term.dtype),
        lax.add,
        window_dimensions=(2 * k, 2 * k, 1),
        window_strides=(1, 1, 1),
        padding=((k - pad_before, (k - 1) - pad_after), (k, k - 1), (0, 0)),
    )
    cost = jnp.where(valid, cost.astype(cost_dtype), _inf_value(cost_dtype))
    return cost


def ssd_cost_from_padded(left_padded: jnp.ndarray, right_padded: jnp.ndarray,
                         *, pad_before: int, pad_after: int,
                         max_disparity: int, kernel_size: int = 7,
                         cost_dtype=jnp.float32) -> jnp.ndarray:
    """SSD cost for a horizontal band of rows carrying explicit row halos.

    Multi-chip building block: each tile owner computes the cost for its
    H-rows from its block plus ``pad_before``/``pad_after`` halo rows pulled
    from neighbors (zeros at the true image edge, which is the additive
    identity of the clipped window sum — see ssd_cost_volume).  The W-axis
    window is handled locally since W is never sharded.

    With ``pad_before = k`` and ``pad_after = k - 1`` this reproduces
    ``ssd_cost_volume`` on the corresponding row block exactly.

    Returns [H_rows, W, D] where H_rows = padded_height - pad_before - pad_after.
    """
    return _diff_cost_from_padded(left_padded, right_padded,
                                  pad_before=pad_before, pad_after=pad_after,
                                  max_disparity=max_disparity,
                                  kernel_size=kernel_size,
                                  cost_dtype=cost_dtype, absolute=False)


def sad_cost_from_padded(left_padded: jnp.ndarray, right_padded: jnp.ndarray,
                         *, pad_before: int, pad_after: int,
                         max_disparity: int, kernel_size: int = 7,
                         cost_dtype=jnp.float32) -> jnp.ndarray:
    """SAD band cost with explicit row halos (see ssd_cost_from_padded)."""
    return _diff_cost_from_padded(left_padded, right_padded,
                                  pad_before=pad_before, pad_after=pad_after,
                                  max_disparity=max_disparity,
                                  kernel_size=kernel_size,
                                  cost_dtype=cost_dtype, absolute=True)


def _birchfield_match_cost(left: jnp.ndarray, right: jnp.ndarray,
                           max_disparity: int,
                           disparity_offset=0) -> jnp.ndarray:
    """Per-pixel Birchfield–Tomasi dissimilarity m[h, p, d].

    Vectorized form of the shared-memory scanline body in
    src/birchfield_cost.cu:110-135, with the zero borders of
    birchfield_cost.cu:95-100 realised by one-pixel zero padding.
    """
    height, width = left.shape
    zeros_col = jnp.zeros((height, 1), left.dtype)
    lpad = jnp.concatenate([zeros_col, left, zeros_col], axis=1)   # [H, W+2]
    rpad = jnp.concatenate([zeros_col, right, zeros_col], axis=1)

    l_c = left                                  # L[p]
    l_m = lpad[:, :width]                       # L[p-1] (zero border)
    l_p = lpad[:, 2:]                           # L[p+1] (zero border)

    # Right samples at p - d (+ neighbours), via one clamped gather into the
    # padded scanline: rpad[i] = R[i-1], rpad[0] = rpad[W+1] = 0.
    p_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 0)
    d_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 1)
    centre = p_idx - d_idx - disparity_offset + 1   # index of R[p-d] in rpad
    r_c = jnp.take(rpad, jnp.clip(centre, 0, width + 1), axis=1)
    r_m = jnp.take(rpad, jnp.clip(centre - 1, 0, width + 1), axis=1)
    r_p = jnp.take(rpad, jnp.clip(centre + 1, 0, width + 1), axis=1)

    half = jnp.asarray(0.5, left.dtype)
    la = half * (l_c + l_m)
    lb = half * (l_c + l_p)
    ra = half * (r_c + r_m[..., :])
    rb = half * (r_c + r_p[..., :])

    l_c3 = l_c[:, :, None]
    la3, lb3 = la[:, :, None], lb[:, :, None]

    lmin = jnp.minimum(jnp.minimum(la3, lb3), l_c3)
    lmax = jnp.maximum(jnp.maximum(la3, lb3), l_c3)
    rmin = jnp.minimum(jnp.minimum(ra, rb), r_c)
    rmax = jnp.maximum(jnp.maximum(ra, rb), r_c)

    zero = jnp.zeros((), left.dtype)
    term_l = jnp.maximum(jnp.maximum(zero, l_c3 - rmax), rmin - l_c3)
    term_r = jnp.maximum(jnp.maximum(zero, r_c - lmax), lmin - r_c)
    return jnp.minimum(term_l, term_r)          # [H, W, D]


@functools.partial(jax.jit, static_argnames=("max_disparity", "kernel_size"))
def birchfield_cost_volume(left: jnp.ndarray, right: jnp.ndarray, *,
                           max_disparity: int,
                           kernel_size: int = 4,
                           disparity_offset=0) -> jnp.ndarray:
    """Birchfield–Tomasi sampling-insensitive cost volume [H, W, D] float32.

    Equivalent to CostOps::ComputeBirchfield (src/birchfield_cost.cu:153-181)
    in its CUDA form.  ``kernel_size`` defaults to 4 — the reference hardcodes
    it despite accepting an argument (stereomatch/cost.py:98-99).
    ``disparity_offset`` selects a disparity block, as in ssd_cost_volume.
    """
    left_f = left.astype(jnp.float32)
    right_f = right.astype(jnp.float32)

    m = _birchfield_match_cost(left_f, right_f, max_disparity,
                               disparity_offset)

    width = left.shape[1]
    p_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 0)
    d_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 1)
    valid = (p_idx >= d_idx + disparity_offset)[None, :, :]
    m = jnp.where(valid, m, 0.0)

    cost = _box_sum(m, kernel_size, axes=(1,))
    return jnp.where(valid, cost, jnp.inf)


def _shift2d_zero(image: jnp.ndarray, rows: int, cols: int) -> jnp.ndarray:
    """Zero-filled shift: out[y, x] = image[y + rows, x + cols]."""
    out = image
    if rows:
        out = jnp.roll(out, -rows, axis=0)
        edge = lax.broadcasted_iota(jnp.int32, out.shape, 0)
        mask = (edge >= image.shape[0] - rows) if rows > 0 else (edge < -rows)
        out = jnp.where(mask, jnp.zeros((), image.dtype), out)
    if cols:
        out = jnp.roll(out, -cols, axis=1)
        edge = lax.broadcasted_iota(jnp.int32, out.shape, 1)
        mask = (edge >= image.shape[1] - cols) if cols > 0 else (edge < -cols)
        out = jnp.where(mask, jnp.zeros((), image.dtype), out)
    return out


@functools.partial(jax.jit, static_argnames=("window_size",))
def census_transform(image: jnp.ndarray, window_size: int = 5) -> jnp.ndarray:
    """Census descriptor per pixel: one bit per window neighbor,
    set when neighbor < center (Zabih-Woodfill census; the robust binary
    cost family — see e.g. "Binary Stereo Matching", arXiv:1402.2020).

    ``window_size`` must be odd.  One bit per neighbor, packed into
    int32 words: up to 5x5 (24 bits) the result is an [H, W] int32 code
    plane (the common case and the historical contract); larger windows
    return [H, W, n_words] stacked planes (7x7 -> 48 bits -> 2 words,
    9x9 -> 80 -> 3, ... — the larger windows production census stacks
    use, e.g. OpenCV's StereoBM-style 9x7).  Out-of-image neighbors read
    as 0, consistent between the two images.

    Beyond the reference's capability surface (its costs are SSD and
    Birchfield-Tomasi); census + Hamming is invariant to any monotonic
    per-image intensity transform, which neither reference cost is.
    """
    if window_size % 2 == 0:
        raise ValueError(f"window_size must be odd (got {window_size})")
    img = image.astype(jnp.float32)
    half = window_size // 2
    n_bits = window_size * window_size - 1
    words = []
    code = jnp.zeros(image.shape, jnp.int32)
    bit = 0
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            if dy == 0 and dx == 0:
                continue
            neighbor = _shift2d_zero(img, dy, dx)
            code = code | ((neighbor < img).astype(jnp.int32) << bit)
            bit += 1
            if bit == 32:
                words.append(code)
                code = jnp.zeros(image.shape, jnp.int32)
                bit = 0
    if bit or not words:
        words.append(code)
    if n_bits <= 32:
        return words[0]
    return jnp.stack(words, axis=-1)


@functools.partial(jax.jit, static_argnames=("max_disparity", "window_size",
                                             "kernel_size", "cost_dtype"))
def census_hamming_cost_volume(left: jnp.ndarray, right: jnp.ndarray, *,
                               max_disparity: int,
                               window_size: int = 5,
                               kernel_size: int = 1,
                               cost_dtype=jnp.float32,
                               disparity_offset=0) -> jnp.ndarray:
    """Hamming distance between census codes, as an [H, W, D] cost volume.

    cost[y, x, d] = popcount(census(L)[y, x] XOR census(R)[y, x - d]),
    optionally box-summed over the same clipped window the SSD kernel
    uses when ``kernel_size > 1``; d > x cells carry +inf / int-max,
    matching the other cost kernels' validity convention.

    Windows above 5x5 pack into several int32 code words
    (census_transform); the Hamming distance is then the sum of per-word
    popcounts — one extra shifted stack + popcount per word.
    """
    cl = census_transform(left, window_size)
    cr = census_transform(right, window_size)
    if cl.ndim == 2:
        cl, cr = cl[..., None], cr[..., None]

    ham = None
    for w in range(cl.shape[-1]):
        shifted = shifted_right_stack(cr[..., w], max_disparity,
                                      disparity_offset)    # [H, W, D] int32
        pc = lax.population_count(cl[..., w][:, :, None] ^ shifted)
        ham = pc if ham is None else ham + pc

    width = left.shape[1]
    w_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 0)
    d_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 1)
    valid = (w_idx >= d_idx + disparity_offset)[None, :, :]

    compute_dtype = _compute_dtype(left.dtype, cost_dtype)
    cost = jnp.where(valid, ham, 0).astype(compute_dtype)
    if kernel_size > 1:
        cost = _box_sum(cost, kernel_size, axes=(0, 1))
    return jnp.where(valid, cost.astype(cost_dtype), _inf_value(cost_dtype))


def _zncc_stack(left_f: jnp.ndarray, shifted: jnp.ndarray,
                valid: jnp.ndarray) -> jnp.ndarray:
    """The six windowed-summand planes of the ZNCC statistics.

    Order: [count, sum_L, sum_L2, sum_R, sum_R2, sum_LR], each masked by
    the per-(column, disparity) validity so the window statistics use
    exactly the clipped column range [max(c-k, d), min(c+k, W)) the SSD
    kernel sums over (ssd.cu:37-42).  ``shifted`` is already zero where
    invalid (shifted_right_stack's out-of-range fill).
    """
    v = jnp.broadcast_to(valid, shifted.shape).astype(jnp.float32)
    l3 = left_f[:, :, None] * v
    return jnp.stack([v, l3, l3 * left_f[:, :, None],
                      shifted, shifted * shifted,
                      left_f[:, :, None] * shifted])


def _zncc_combine(sums: jnp.ndarray, valid: jnp.ndarray,
                  cost_dtype, eps) -> jnp.ndarray:
    """Window statistics [6, H, W, D] -> ZNCC cost ``1 - ncc`` in [0, 2].

    Windows with (near-)zero variance on either side carry the neutral
    cost 1 (ncc defined as 0 there): a flat patch matches nothing and
    everything equally, and amplifying quantization noise with a tiny
    denominator would make it match arbitrarily.
    """
    n, s_l, s_ll, s_r, s_rr, s_lr = sums
    n_safe = jnp.maximum(n, 1.0)
    cov = s_lr - s_l * s_r / n_safe
    var_l = jnp.maximum(s_ll - s_l * s_l / n_safe, 0.0)
    var_r = jnp.maximum(s_rr - s_r * s_r / n_safe, 0.0)
    denom = jnp.sqrt(var_l * var_r)
    ncc = jnp.where(denom > eps, cov / jnp.maximum(denom, eps), 0.0)
    cost = 1.0 - ncc
    return jnp.where(valid, cost.astype(cost_dtype), _inf_value(cost_dtype))


def pairwise_sum_last(v: jnp.ndarray) -> jnp.ndarray:
    """Deterministic-association sum along the last axis.

    Zero-pads to a power of two and folds the axis in half repeatedly
    with ELEMENTWISE adds.  Unlike ``jnp.sum`` (a reduce op whose tree
    XLA may pick differently per fusion context / shape — observed
    1-14 ulp scalar drift between the single-chip and shard_map
    lowerings of the very same [1, H] reduce), an explicit add chain is
    IEEE-fixed: XLA never reassociates floating-point adds it didn't
    create.  The association depends only on the axis LENGTH, so a row
    band computes bit-identical per-row sums to the full image.
    log2(n) passes over a halving array — negligible against any
    volume-sized work.
    """
    n = v.shape[-1]
    p = 1 << max((n - 1).bit_length(), 0)
    if p != n:
        pad = [(0, 0)] * (v.ndim - 1) + [(0, p - n)]
        v = jnp.pad(v, pad)
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def stable_image_mean(img: jnp.ndarray) -> jnp.ndarray:
    """Global mean with a sharding-stable association.

    A plain ``jnp.mean`` over [H, W] lets XLA pick the reduction tree,
    which changes with sharding and even with fusion context — a
    row-sharded caller could never reproduce the scalar bit-for-bit.
    Both stages therefore use ``pairwise_sum_last``'s fixed add chain:
    per-row sums (chain depends on W alone, so a row band computes the
    identical values) then the [H] vector (each chip re-reduces the
    all-gathered copy with the identical chain).  zncc centering uses
    this so the sharded prefix path can match the single-chip volume
    exactly (tests/test_parallel.py::test_sharded_ncc pins it).
    """
    row_sums = pairwise_sum_last(img.astype(jnp.float32))        # [H]
    total = pairwise_sum_last(row_sums)
    return total / (img.shape[0] * img.shape[1])


def _rowboxed_prefix(img: jnp.ndarray, kernel_size: int) -> jnp.ndarray:
    """[H, W+1] row-box-summed column prefix of a plane.

    RBS[r, j] = sum over window rows r' of (sum over columns x < j of
    img[r', x]) — the building block that turns every per-window column
    sum into a difference of two entries: the full windowed sum over
    columns [a, b) at row r is RBS[r, b] - RBS[r, a].  Row clipping comes
    from the box pass's zero padding (out-of-image rows contribute 0).
    """
    height = img.shape[0]
    prefix = jnp.concatenate(
        [jnp.zeros((height, 1), img.dtype), jnp.cumsum(img, axis=1)],
        axis=1)
    return _box_sum(prefix, kernel_size, axes=(0,))


def _window_ends(plane: jnp.ndarray, kernel_size: int):
    """(upper, lower) per-column reads of an [H, W+1] prefix-style plane:
    upper[., c] = plane[., min(c+k, W)], lower[., c] = plane[., max(c-k,
    0)] — static concat/broadcast re-indexing, no gathers."""
    k = kernel_size
    width = plane.shape[-1] - 1
    upper = jnp.concatenate(
        [plane[..., k:],
         jnp.broadcast_to(plane[..., -1:],
                          plane.shape[:-1] + (k - 1,))], axis=-1)
    lower = jnp.concatenate(
        [jnp.broadcast_to(plane[..., :1], plane.shape[:-1] + (k,)),
         plane[..., :width - k]], axis=-1)
    return upper, lower


def _shifted_plane_stack(plane: jnp.ndarray, max_disparity: int,
                         disparity_offset) -> jnp.ndarray:
    """[H, Wp, D] stack G[r, x, d] = plane[r, x - d - offset] (0 when the
    source index is negative) — shifted_right_stack generalized to
    prefix-width planes."""
    wp = plane.shape[1]
    x_idx = lax.broadcasted_iota(jnp.int32, (wp, max_disparity), 0)
    d_idx = lax.broadcasted_iota(jnp.int32, (wp, max_disparity), 1)
    src = x_idx - d_idx - disparity_offset
    valid = src >= 0
    gathered = jnp.take(plane, jnp.maximum(src, 0), axis=1)
    return jnp.where(valid[None], gathered, jnp.zeros((), plane.dtype))


@functools.partial(jax.jit, static_argnames=("max_disparity", "kernel_size",
                                             "cost_dtype"))
def zncc_cost_volume(left: jnp.ndarray, right: jnp.ndarray, *,
                     max_disparity: int, kernel_size: int = 7,
                     cost_dtype=jnp.float32,
                     disparity_offset=0, eps: float = 1e-6) -> jnp.ndarray:
    """Zero-mean normalized cross-correlation cost volume [H, W, D].

    Beyond the reference's cost surface: ``cost = 1 - zncc`` over the same
    clipped window as SSD, invariant to *affine* (gain + bias) radiometric
    mismatch between the two cameras — where SSD/SAD degrade under any
    mismatch and census handles only monotonic transforms losslessly.

    Of the six window statistics only ΣLR genuinely couples both images
    per disparity and gets the volume-sized separable box pass.  The
    rest are *plane* algebra: ΣL/ΣL² are prefix-difference reads of
    row-box-summed column prefixes (the window's d-dependent left clip
    max(c-k, d) selects between a column plane and a disparity plane);
    ΣR/ΣR² are the same prefix planes read through a shifted stack; the
    count is a closed-form row-extent x column-extent product.  That
    takes the round-2 formulation's ~31 volume-sized HBM transfers (six
    stacked statistics through two box passes) down to ~7.

    Both images are centered by their global means first — ZNCC is
    invariant to per-image shifts, and small-magnitude prefixes keep the
    prefix-difference cancellation at window-sum scale instead of
    image-sum scale.  Always computes float32; ``cost_dtype`` must be a
    float dtype.
    """
    cost_dtype = jnp.dtype(cost_dtype)
    if not jnp.issubdtype(cost_dtype, jnp.floating):
        raise ValueError("zncc cost requires a float cost_dtype "
                         f"(got {cost_dtype})")
    k = kernel_size
    # disparity_offset may be traced (disp-sharded blocks derive it from
    # the device's axis index) — use it in the degenerate-geometry guard
    # only when concrete.  Traced offsets come from the disparity
    # partitioner whose blocks always satisfy offset + block <= D <= W,
    # and dynamic_slice clamps a traced start anyway; the slice-SIZE
    # overrun (max_disparity alone exceeding the [H, W+1] prefix plane)
    # is still caught with offset treated as 0.
    _off = (int(disparity_offset)
            if not isinstance(disparity_offset, jax.core.Tracer) else 0)
    if (left.shape[1] <= k
            or left.shape[1] + 1 < _off + max_disparity):
        # Degenerate geometries: width so small every window spans the
        # whole image (the static prefix re-indexing assumes W > k), or
        # a disparity range overrunning the [H, W+1] prefix plane
        # (disparity_offset + D > W + 1 would make the at_d slice throw).
        # The stacked formulation is fine at these scales — such volumes
        # are mostly the invalid wedge anyway.
        left_f = left.astype(jnp.float32)
        right_f = right.astype(jnp.float32)
        shifted = shifted_right_stack(right_f, max_disparity,
                                      disparity_offset)
        width = left.shape[1]
        w_i = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 0)
        d_i = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 1)
        valid = (w_i >= d_i + disparity_offset)[None, :, :]
        stack = _zncc_stack(left_f, shifted, valid)
        sums = _box_sum(stack, kernel_size, axes=(1, 2))
        return _zncc_combine(sums, valid, cost_dtype, eps)
    left_c = left.astype(jnp.float32)
    right_c = right.astype(jnp.float32)
    # Sharding-stable mean association (see stable_image_mean) so the
    # row-sharded prefix path can reproduce these scalars bit-for-bit.
    left_c = left_c - stable_image_mean(left_c)
    right_c = right_c - stable_image_mean(right_c)
    height, width = left_c.shape

    w_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 0)
    d_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 1)
    delta = d_idx + disparity_offset
    valid = (w_idx >= delta)[None, :, :]

    # Window support count: rows(r) x columns(c, d), both closed-form.
    r_idx = jnp.arange(height)
    rows_n = (jnp.minimum(r_idx + k, height)
              - jnp.maximum(r_idx - k, 0)).astype(jnp.float32)
    cols_n = jnp.maximum(jnp.minimum(w_idx + k, width)
                         - jnp.maximum(w_idx - k, delta), 0
                         ).astype(jnp.float32)
    n = rows_n[:, None, None] * cols_n[None]

    # Left-image statistics: prefix-difference planes.  The column window
    # is [max(c-k, d), min(c+k, W)): the upper end and the c-k lower end
    # are per-column planes; when the d clip wins the lower read comes
    # from the per-disparity plane RBS[:, d] instead.
    cmask = ((w_idx - k) >= delta)[None, :, :]

    def left_stat(img):
        rbs = _rowboxed_prefix(img, k)                       # [H, W+1]
        upper, lower = _window_ends(rbs, k)                  # [H, W] x2
        at_d = lax.dynamic_slice_in_dim(
            rbs, disparity_offset, max_disparity, axis=1)    # [H, D]
        return upper[:, :, None] - jnp.where(cmask, lower[:, :, None],
                                             at_d[:, None, :])

    s_l = left_stat(left_c)
    s_ll = left_stat(left_c * left_c)

    # Right-image statistics: the same prefix planes, read at shifted
    # columns — G[r, x, d] = RBS_R[r, x - d], so the window ends become
    # static re-indexes of one shifted stack (the zero fill of the stack
    # IS the max(c-k, d) clip: a clipped lower end reads RBS_R[0] = 0).
    def right_stat(img):
        g = _shifted_plane_stack(_rowboxed_prefix(img, k), max_disparity,
                                 disparity_offset)           # [H, W+1, D]
        upper = jnp.concatenate(
            [g[:, k:], jnp.broadcast_to(g[:, -1:],
                                        (height, k - 1, max_disparity))],
            axis=1)
        lower = jnp.concatenate(
            [jnp.zeros((height, k, max_disparity), g.dtype),
             g[:, :width - k]], axis=1)
        return upper - lower

    s_r = right_stat(right_c)
    s_rr = right_stat(right_c * right_c)

    # The one statistic that needs a volume-sized box pass: the shifted
    # stack's zero fill makes out-of-window products the additive
    # identity, so the plain clipped box implements the d-dependent clip.
    shifted = shifted_right_stack(right_c, max_disparity, disparity_offset)
    s_lr = _box_sum(left_c[:, :, None] * shifted, k, axes=(0, 1))

    return _zncc_combine((n, s_l, s_ll, s_r, s_rr, s_lr), valid,
                         cost_dtype, eps)


def zncc_cost_from_padded(left_padded: jnp.ndarray,
                          right_padded: jnp.ndarray, *,
                          pad_before: int, pad_after: int,
                          max_disparity: int, kernel_size: int = 7,
                          cost_dtype=jnp.float32,
                          eps: float = 1e-6,
                          row_valid=None,
                          left_mean=None, right_mean=None) -> jnp.ndarray:
    """ZNCC band cost with explicit row halos (see ssd_cost_from_padded).

    Round 5: this is the single-chip prefix-plane formulation
    (zncc_cost_volume) run on the padded tile and cropped — NOT a
    separate reduce_window body — so the sharded volume is bit-equal to
    the unsharded one (the round-4 parity gap this closes).  The pieces
    that make that exact:

    * Every cross-row operation in the prefix path is a [r-k, r+k) row
      box; on the padded tile the same 2k-tap window reads real halo
      rows where the single-chip box read in-image rows and exact zeros
      where it read padding (out-of-image halo rows are zeroed below),
      so each window sums identical values in identical order.
    * Centering must subtract the SAME global-mean scalar the
      single-chip path computes; callers under a mesh pass
      ``left_mean``/``right_mean`` (per stable_image_mean: all-gather
      the per-row sums, re-reduce the identical [H] vector per chip).
      None falls back to a tile-local mean over the real rows —
      mathematically equivalent (ZNCC is shift-invariant) but only
      bit-equal when the tile IS the whole image.
    * The window *count* comes from a row box over ``row_valid``
      ([padded_height] bool, True inside the real image): both paths
      then hold identical small-integer floats, matching the
      single-chip closed form.  None means all padded rows are real
      data (interior tiles / full halos).
    """
    cost_dtype = jnp.dtype(cost_dtype)
    if not jnp.issubdtype(cost_dtype, jnp.floating):
        raise ValueError("zncc cost requires a float cost_dtype "
                         f"(got {cost_dtype})")
    k = kernel_size
    if pad_before > k or pad_after > k - 1:
        raise ValueError("halos wider than the window change the semantics")
    hp, width = left_padded.shape
    height = hp - pad_before - pad_after
    if width <= k or width + 1 < max_disparity:
        # The prefix re-indexing needs W > k and D <= W + 1 (the
        # single-chip path falls back to a stacked formulation at these
        # degenerate scales; sharded callers always pass full-width
        # tiles, so just reject).
        raise ValueError(
            f"zncc_cost_from_padded needs width > kernel_size and "
            f"max_disparity <= width + 1 (got W={width}, k={k}, "
            f"D={max_disparity})")
    left_f = left_padded.astype(jnp.float32)
    right_f = right_padded.astype(jnp.float32)

    rows_real = (jnp.ones((hp,), jnp.float32) if row_valid is None
                 else row_valid.astype(jnp.float32))
    if left_mean is None:
        denom = jnp.maximum(jnp.sum(rows_real) * width, 1.0)
        left_mean = jnp.sum(jnp.sum(left_f, axis=1) * rows_real) / denom
        right_mean = jnp.sum(jnp.sum(right_f, axis=1) * rows_real) / denom
    # Center, then zero the out-of-image halo rows so they behave
    # exactly like the single-chip box pass's zero padding (centering
    # first would leave them at -mean, poisoning edge windows).
    rmask = rows_real[:, None] > 0
    left_c = jnp.where(rmask, left_f - left_mean, 0.0)
    right_c = jnp.where(rmask, right_f - right_mean, 0.0)

    w_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 0)
    d_idx = lax.broadcasted_iota(jnp.int32, (width, max_disparity), 1)
    valid = (w_idx >= d_idx)[None, :, :]

    def row_box(x):
        """[i-k, i+k) row box via reduce_window (halo-stable: each
        window sums the same values in the same order on a tile)."""
        window = [1] * x.ndim
        padding = [(0, 0)] * x.ndim
        window[0] = 2 * k
        padding[0] = (k, k - 1)
        return lax.reduce_window(x, jnp.zeros((), x.dtype), lax.add,
                                 window_dimensions=tuple(window),
                                 window_strides=(1,) * x.ndim,
                                 padding=tuple(padding))

    # Window support count: rows from a box over the validity row
    # vector (identical small integers to the single-chip closed form),
    # columns closed-form as single-chip.
    rows_n = row_box(rows_real)                                 # [Hp]
    cols_n = jnp.maximum(jnp.minimum(w_idx + k, width)
                         - jnp.maximum(w_idx - k, d_idx), 0
                         ).astype(jnp.float32)
    n = rows_n[:, None, None] * cols_n[None]

    cmask = ((w_idx - k) >= d_idx)[None, :, :]

    def left_stat(img):
        prefix = jnp.concatenate(
            [jnp.zeros((hp, 1), img.dtype), jnp.cumsum(img, axis=1)],
            axis=1)
        rbs = row_box(prefix)                                   # [Hp, W+1]
        upper, lower = _window_ends(rbs, k)
        at_d = rbs[:, :max_disparity]                           # offset 0
        return upper[:, :, None] - jnp.where(cmask, lower[:, :, None],
                                             at_d[:, None, :])

    s_l = left_stat(left_c)
    s_ll = left_stat(left_c * left_c)

    def right_stat(img):
        prefix = jnp.concatenate(
            [jnp.zeros((hp, 1), img.dtype), jnp.cumsum(img, axis=1)],
            axis=1)
        g = _shifted_plane_stack(row_box(prefix), max_disparity, 0)
        upper = jnp.concatenate(
            [g[:, k:], jnp.broadcast_to(g[:, -1:],
                                        (hp, k - 1, max_disparity))],
            axis=1)
        lower = jnp.concatenate(
            [jnp.zeros((hp, k, max_disparity), g.dtype),
             g[:, :width - k]], axis=1)
        return upper - lower

    s_r = right_stat(right_c)
    s_rr = right_stat(right_c * right_c)

    shifted = shifted_right_stack(right_c, max_disparity)    # [Hp, W, D]
    s_lr = _box_sum(row_box(left_c[:, :, None] * shifted), k, axes=(1,))

    cost = _zncc_combine((n, s_l, s_ll, s_r, s_rr, s_lr), valid,
                         cost_dtype, eps)
    return lax.dynamic_slice_in_dim(cost, pad_before, height, axis=0)


def ssd_texture_cost_volume(left_texture, right_texture, *,
                            max_disparity: int,
                            kernel_size: int = 7) -> jnp.ndarray:
    """SSD over sampled textures.

    Port of the tex2D-based kernel (src/ssd.cu:83-136) without texture
    units: the texture abstraction (`stereomatch_tpu.texture`) is a
    gather-based sampler with clamp addressing and nearest filtering, which
    over integer pixel centres returns the underlying image exactly — so the
    cost matches `ssd_cost_volume` bit-for-bit, mirroring the reference where
    the texture and tensor paths agree (tests/test_cost.py:41-57).
    """
    from ..texture import TextureImage  # local import to avoid cycle

    if not isinstance(left_texture, TextureImage):
        raise TypeError("ssd_texture_cost_volume expects TextureImage inputs")
    if left_texture.use_normalized_coords or right_texture.use_normalized_coords:
        raise RuntimeError(
            "Texture coordinates can't be normalized for this implementation")
    left = left_texture.sample_grid()
    right = right_texture.sample_grid()
    return ssd_cost_volume(left, right, max_disparity=max_disparity,
                           kernel_size=kernel_size, cost_dtype=jnp.float32)
