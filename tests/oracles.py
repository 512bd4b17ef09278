"""Naive NumPy oracles transcribing the reference kernels' semantics.

These are deliberately slow, per-pixel implementations that follow the
reference CUDA/C++ control flow one-to-one, used as the correctness anchor
for the vectorized JAX ops — the same oracle pattern the reference uses
(its CPU kernels anchor its GPU kernels, tests/test_cost.py:41-57).

Citations refer to /root/reference source locations.
"""

from __future__ import annotations

import numpy as np

INF = np.float32(np.inf)


def ssd_oracle(left: np.ndarray, right: np.ndarray, max_disparity: int,
               kernel_size: int = 7) -> np.ndarray:
    """src/ssd.cu:31-61 (SSDKernel::operator())."""
    height, width = left.shape
    k = kernel_size
    left = left.astype(np.float32)
    right = right.astype(np.float32)
    cost = np.empty((height, width, max_disparity), np.float32)
    for row in range(height):
        for col in range(width):
            for disp in range(min(col + 1, max_disparity)):
                row_start, row_end = max(row - k, 0), min(row + k, height)
                col_start = abs(min(col - disp - k, 0)) + col - k
                col_end = min(col + k, width)
                lw = left[row_start:row_end, col_start:col_end]
                rw = right[row_start:row_end, col_start - disp:col_end - disp]
                d = lw - rw
                cost[row, col, disp] = np.sum(d * d)
            for disp in range(col + 1, max_disparity):
                cost[row, col, disp] = INF
    return cost


def sad_oracle(left: np.ndarray, right: np.ndarray, max_disparity: int,
               kernel_size: int = 7) -> np.ndarray:
    """SSD window semantics (src/ssd.cu:31-61) with an L1 summand —
    beyond-reference cost family, anchored to the same window rules."""
    height, width = left.shape
    k = kernel_size
    left = left.astype(np.float32)
    right = right.astype(np.float32)
    cost = np.empty((height, width, max_disparity), np.float32)
    for row in range(height):
        for col in range(width):
            for disp in range(min(col + 1, max_disparity)):
                row_start, row_end = max(row - k, 0), min(row + k, height)
                col_start = max(col - k, disp)
                col_end = min(col + k, width)
                lw = left[row_start:row_end, col_start:col_end]
                rw = right[row_start:row_end, col_start - disp:col_end - disp]
                cost[row, col, disp] = np.sum(np.abs(lw - rw))
            for disp in range(col + 1, max_disparity):
                cost[row, col, disp] = INF
    return cost


def zncc_oracle(left: np.ndarray, right: np.ndarray, max_disparity: int,
                kernel_size: int = 7, eps: float = 1e-6) -> np.ndarray:
    """1 - ZNCC over the SSD window (beyond-reference cost family).

    Statistics run over exactly the clipped window's (left, right) sample
    pairs; windows whose either side has (near-)zero variance get the
    neutral cost 1.  Computed in float64 here — the vectorized f32 kernel
    is compared against this with a tolerance.
    """
    height, width = left.shape
    k = kernel_size
    left = left.astype(np.float64)
    right = right.astype(np.float64)
    cost = np.empty((height, width, max_disparity), np.float64)
    for row in range(height):
        for col in range(width):
            for disp in range(min(col + 1, max_disparity)):
                row_start, row_end = max(row - k, 0), min(row + k, height)
                col_start = max(col - k, disp)
                col_end = min(col + k, width)
                lw = left[row_start:row_end, col_start:col_end].ravel()
                rw = right[row_start:row_end,
                           col_start - disp:col_end - disp].ravel()
                n = lw.size
                cov = np.dot(lw, rw) - lw.sum() * rw.sum() / n
                var_l = max(np.dot(lw, lw) - lw.sum() ** 2 / n, 0.0)
                var_r = max(np.dot(rw, rw) - rw.sum() ** 2 / n, 0.0)
                denom = np.sqrt(var_l * var_r)
                ncc = cov / denom if denom > eps else 0.0
                cost[row, col, disp] = 1.0 - ncc
            for disp in range(col + 1, max_disparity):
                cost[row, col, disp] = INF
    return cost


def birchfield_oracle(left: np.ndarray, right: np.ndarray, max_disparity: int,
                      kernel_size: int = 4) -> np.ndarray:
    """src/birchfield_cost.cu:83-139 (the CUDA variant: zero-padded scanlines).

    Cells with d > x, which the reference leaves uninitialized, are +inf here
    (matching the JAX implementation's documented deviation).
    """
    height, width = left.shape
    K = kernel_size
    cost = np.full((height, width, max_disparity), INF, np.float32)
    lpad = np.zeros((height, width + 2), np.float32)
    rpad = np.zeros((height, width + 2), np.float32)
    lpad[:, 1:-1] = left
    rpad[:, 1:-1] = right
    for y in range(height):
        L, R = lpad[y], rpad[y]
        for x in range(width):
            for disp in range(min(max_disparity, x + 1)):
                start = max(0, x - disp - K) + disp
                end = min(width, x + K)
                total = np.float32(0)
                for p in range(start, end):
                    li, ri = p + 1, p - disp + 1
                    lI, rI = L[li], R[ri]
                    laI = 0.5 * (lI + L[li - 1])
                    lbI = 0.5 * (lI + L[li + 1])
                    raI = 0.5 * (rI + R[ri - 1])
                    rbI = 0.5 * (rI + R[ri + 1])
                    lmi, lma = min(laI, lbI, lI), max(laI, lbI, lI)
                    rmi, rma = min(raI, rbI, rI), max(raI, rbI, rI)
                    total += min(max(0.0, lI - rma, rmi - lI),
                                 max(0.0, rI - lma, lmi - rI))
                cost[y, x, disp] = total
    return cost


def _sgm_path(cost, image, out, start, direction, size, p1, p2):
    """src/semiglobal.cpp:116-159 (SGMCostOperator::operator())."""
    max_disp = cost.shape[2]
    x, y = start
    prev = cost[y, x].astype(np.float64).copy()
    out[y, x] += prev
    prev_int = image[y, x]
    for _ in range(1, size):
        prev_min = prev.min()
        x += direction[0]
        y += direction[1]
        intensity = image[y, x]
        dI = abs(float(intensity) - float(prev_int))
        p2_adj = max(p1, p2 / dI) if dI > 0 else INF
        prev_int = intensity
        cur = np.empty_like(prev)
        for d in range(max_disp):
            c_m1 = prev[d - 1] if d > 0 else INF
            c_p1 = prev[d + 1] if d < max_disp - 1 else INF
            cur[d] = cost[y, x, d] + min(prev[d], c_m1 + p1, c_p1 + p1,
                                         prev_min + p2_adj) - prev_min
        out[y, x] += cur
        prev = cur


def generate_sgm_paths(width: int, height: int):
    """src/semiglobal.cpp:18-91 (SGPixelPath::GeneratePaths).

    Yields (start_xy, direction_xy, size) triples; each is also traversed
    inverted by the caller (semiglobal.cpp:191-194).
    """
    paths = []
    for i in range(height):                       # horizontal
        paths.append(((0, i), (1, 0), width))
    for i in range(width):                        # vertical
        paths.append(((i, 0), (0, 1), height))
    for i in range(width):                        # diag down-right, top edge
        start = (width - 1 - i, 0)
        end_y = min(i, height - 1)
        paths.append((start, (1, 1), end_y - 0 + 1))
    for i in range(height - 1):                   # diag down-right, left edge
        start = (0, i + 1)
        end_x = min(height - 1 - (i + 1), width - 1)
        paths.append((start, (1, 1), end_x - 0 + 1))
    for i in range(width):                        # diag down-left, top edge
        paths.append(((i, 0), (-1, 1), min(i + 1, height)))
    for i in range(height - 1):                   # diag down-left, right edge
        paths.append(((width - 1, i + 1), (-1, 1),
                      min(height - (i + 1), width)))
    return paths


def _invert_path(start, direction, size):
    """src/semiglobal.hpp SGPixelPath::inverse()."""
    end = (start[0] + direction[0] * (size - 1),
           start[1] + direction[1] * (size - 1))
    return end, (-direction[0], -direction[1]), size


def sgm_oracle(cost: np.ndarray, image: np.ndarray,
               p1: float = 0.1, p2: float = 0.2) -> np.ndarray:
    """src/semiglobal.cpp:167-197 (CPU RunSemiglobal)."""
    height, width = image.shape
    out = np.zeros_like(cost, np.float64)
    for start, direction, size in generate_sgm_paths(width, height):
        _sgm_path(cost, image, out, start, direction, size, p1, p2)
        inv_start, inv_dir, inv_size = _invert_path(start, direction, size)
        _sgm_path(cost, image, out, inv_start, inv_dir, inv_size, p1, p2)
    return out.astype(np.float32)


def census_oracle(left: np.ndarray, right: np.ndarray, max_disparity: int,
                  window_size: int = 5, kernel_size: int = 1) -> np.ndarray:
    """Naive census + Hamming cost (Zabih–Woodfill; zero out-of-image
    neighbors, d > x cells +inf, optional clipped box window like SSD)."""
    height, width = left.shape
    half = window_size // 2

    def census(img):
        img = img.astype(np.float32)
        # object dtype: arbitrary-precision python ints, so any window
        # size works (7x7 = 48 bits, 9x9 = 80 overflow int64)
        codes = np.zeros((height, width), object)
        bit = 0
        for dy in range(-half, half + 1):
            for dx in range(-half, half + 1):
                if dy == 0 and dx == 0:
                    continue
                for y in range(height):
                    for x in range(width):
                        ny, nx = y + dy, x + dx
                        nb = (img[ny, nx]
                              if 0 <= ny < height and 0 <= nx < width
                              else 0.0)
                        if nb < img[y, x]:
                            codes[y, x] |= 1 << bit
                bit += 1
        return codes

    cl, cr = census(left), census(right)
    cost = np.full((height, width, max_disparity), INF, np.float32)
    for y in range(height):
        for x in range(width):
            for d in range(min(x + 1, max_disparity)):
                cost[y, x, d] = bin(cl[y, x] ^ cr[y, x - d]).count("1")
    if kernel_size > 1:
        k = kernel_size
        summed = np.zeros_like(cost)
        masked = np.where(np.isfinite(cost), cost, 0.0)
        for y in range(height):
            for x in range(width):
                ys, ye = max(y - k, 0), min(y + k, height)
                xs, xe = max(x - k, 0), min(x + k, width)
                summed[y, x] = masked[ys:ye, xs:xe].sum(axis=(0, 1))
        cost = np.where(np.isfinite(cost), summed, INF)
    return cost


def wta_oracle(cost: np.ndarray) -> np.ndarray:
    """src/winners_take_all.cu:21-40 (CPU linear scan, ties -> lower index)."""
    return np.argmin(cost, axis=2).astype(np.int32)


def dynamic_programming_oracle(cost: np.ndarray) -> np.ndarray:
    """src/dynamic_programming.cu (GPU index semantics; col-0 pointers = 0)."""
    height, width, max_disp = cost.shape
    cost = cost.astype(np.float32)
    path = np.zeros((height, width, max_disp), np.int8)
    disparity = np.zeros((height, width), np.int32)
    for row in range(height):
        prev = cost[row, 0].copy()
        for col in range(1, width):
            cur = np.empty_like(prev)
            for d in range(max_disp):
                c1 = prev[d - 1] if d > 0 else INF
                c2 = prev[d]
                c3 = prev[d + 1] if d < max_disp - 1 else INF
                if c1 < c2 and c1 < c3:
                    mc, pd = c1, -1
                elif c2 < c3:
                    mc, pd = c2, 0
                else:
                    mc, pd = c3, 1
                path[row, col, d] = pd
                cur[d] = cost[row, col, d] + mc
            prev = cur
        current = int(np.argmin(prev))
        disparity[row, width - 1] = current
        for col in range(width - 2, -1, -1):
            current = int(np.clip(current + path[row, col, current],
                                  0, max_disp - 1))
            disparity[row, col] = current
    return disparity


def guided_filter_oracle(vol: np.ndarray, guide: np.ndarray,
                         radius: int, eps: float) -> np.ndarray:
    """Masked guided cost-volume filter, direct windowed form (float64).

    Documented semantics of ops/cvf.py: symmetric clipped (2r+1) windows,
    every mean normalized by the number of *valid* (finite) cells inside,
    second stage averaging only windows centered at valid cells, +inf
    invalid entries preserved.
    """
    height, width, _ = vol.shape
    vol = np.asarray(vol, np.float64)
    guide = np.asarray(guide, np.float64)
    finite = np.isfinite(vol)
    p0 = np.where(finite, vol, 0.0)

    def window(y, x):
        return (slice(max(0, y - radius), min(height, y + radius + 1)),
                slice(max(0, x - radius), min(width, x + radius + 1)))

    a = np.zeros_like(p0)
    b = np.zeros_like(p0)
    for y in range(height):
        for x in range(width):
            ys, xs = window(y, x)
            v = finite[ys, xs]
            n = np.maximum(v.sum(axis=(0, 1)), 1.0)
            g = guide[ys, xs][:, :, None]
            mean_p = p0[ys, xs].sum(axis=(0, 1)) / n
            mean_i = (g * v).sum(axis=(0, 1)) / n
            corr_ip = (g * p0[ys, xs]).sum(axis=(0, 1)) / n
            corr_ii = (g * g * v).sum(axis=(0, 1)) / n
            var_i = np.maximum(corr_ii - mean_i * mean_i, 0.0)
            a[y, x] = (corr_ip - mean_i * mean_p) / (var_i + eps)
            b[y, x] = mean_p - a[y, x] * mean_i

    out = np.full_like(p0, np.inf)
    for y in range(height):
        for x in range(width):
            ys, xs = window(y, x)
            v = finite[ys, xs]
            n = np.maximum(v.sum(axis=(0, 1)), 1.0)
            q = ((a[ys, xs] * v).sum(axis=(0, 1)) / n * guide[y, x]
                 + (b[ys, xs] * v).sum(axis=(0, 1)) / n)
            out[y, x] = np.where(finite[y, x], q, np.inf)
    return out
