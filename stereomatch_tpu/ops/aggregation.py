"""Semiglobal-matching cost aggregation (functional, jittable).

Array-level re-design of the reference SGM kernels
(``src/semiglobal.cpp:93-197`` CPU, ``src/semiglobal_gpu.cu:23-142`` GPU).

The reference enumerates explicit pixel paths — ``height`` horizontal +
``width`` vertical + ``W+H-1`` down-right diagonals + ``W+H-1`` down-left
diagonals (src/semiglobal.cpp:18-91), each traversed forward and inverted
(semiglobal.cpp:191-194) — and walks them sequentially (CPU) or one CUDA
block per path with one thread per disparity and a __syncthreads tree
min-reduction per step (semiglobal_gpu.cu:43-105).

Here every family becomes ONE ``lax.scan`` whose carry holds the running
path costs of *all* paths of that family at once, vectorized over
(orthogonal-axis, disparity), and the per-step band-min recurrence is pure
elementwise work:

  family          scan axis   carry [N, D]      predecessor offset in carry
  horizontal      W           N = H             0
  vertical        H           N = W             0
  diagonal (1,1)  H           N = W             +1   (came from column x-1)
  diagonal (-1,1) H           N = W             -1   (came from column x+1)

This formulation is the semantic oracle and runs on any backend; on an
NVIDIA Hopper GPU the same recurrence runs as a CUDA kernel that walks each
path with one warp (ops/sgm_cuda.cu), chosen by utils/backend.py.

Diagonal paths need no skewed copies of the volume: shifting the carry by
one column per row step realises the diagonal predecessor, and path *starts*
(image top edge, plus the left/right edge column that the shift exposes) are
reset positions where the carry re-seeds from the raw cost.  The reverse
traversals are the same scan over an axis-flipped volume.

Semantics matched to the reference recurrence (semiglobal.cpp:146-152):
    L(p, d) = C(p, d)
              + min(L(p-1, d), L(p-1, d-1) + P1, L(p-1, d+1) + P1,
                    min_d' L(p-1, d') + P2_adj)
              - min_d' L(p-1, d')
with the image-gradient-adaptive penalty (semiglobal.cpp:137-138)
    P2_adj = max(P1, P2 / |I(p) - I(p-1)|)
(|dI| = 0 gives P2_adj = +inf via IEEE division, dropping that term exactly
as the C++ float division does), d-1/d+1 reads beyond the band are +inf
(semiglobal_gpu.cu:61-65), and all eight traversals *accumulate* into an
output volume initialised to zero (aggregation.py:51, semiglobal.cpp:127,153).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

_INF = jnp.inf


def sgm_scan_with_carry(cost_sv: jnp.ndarray, image_sv: jnp.ndarray,
                        penalty1: float, penalty2: float,
                        carry_shift: int,
                        init_carry=None,
                        seed_first=True):
    """Run one SGM sweep over scan-major inputs, exposing the carry.

    This is the chunk-level building block for multi-device SGM: a sweep
    over a tile of the scan axis starts from ``init_carry`` (handed off from
    the neighboring tile owner) and returns its final carry for the next
    tile (see stereomatch_tpu.parallel.sharded).

    Args:
      cost_sv: [S, N, D] cost volume, S = scan axis (path direction),
        N = all parallel paths of the family, D = disparity.
      image_sv: [S, N] left-image intensities in the same layout.
      penalty1/penalty2: SGM penalties.
      carry_shift: predecessor offset along N (0 for axis-aligned paths,
        +1 / -1 for diagonals).
      init_carry: optional (prev_costs [N, D] f32, prev_intensity [N] f32)
        carried in from the preceding chunk of a split scan axis.  None means
        path start (+inf costs; first step re-seeds when ``seed_first``).
      seed_first: whether step 0 is a true path start that re-seeds from the
        raw cost (semiglobal.cpp:121-127).  Pass False (or a traced bool) for
        continuation chunks.  May be a traced scalar bool.

    Returns:
      ((final_prev [N, D], final_intensity [N]), contributions [S, N, D]).
    """
    n = cost_sv.shape[1]
    p1 = jnp.float32(penalty1)
    p2 = jnp.float32(penalty2)
    inf = jnp.float32(_INF)

    # Positions (along N) where the carry shift exposes a fresh path start
    # every step: the column the diagonal enters the image through.
    if carry_shift == 0:
        edge_start = jnp.zeros((n, 1), bool)
    elif carry_shift > 0:
        edge_start = (lax.broadcasted_iota(jnp.int32, (n, 1), 0) == 0)
    else:
        edge_start = (lax.broadcasted_iota(jnp.int32, (n, 1), 0) == n - 1)

    def shift_n(arr, fill):
        if carry_shift == 0:
            return arr
        shifted = jnp.roll(arr, carry_shift, axis=0)
        return jnp.where(edge_start if arr.ndim == 2 else edge_start[:, 0],
                         fill, shifted)

    seed_first = jnp.asarray(seed_first, bool)

    def step(carry, inputs):
        prev, prev_int = carry            # [N, D], [N]
        cost, intensity, is_first = inputs

        prev = shift_n(prev, inf)
        prev_int = shift_n(prev_int, jnp.float32(0))

        prev_min = jnp.min(prev, axis=-1, keepdims=True)           # [N, 1]
        grad = jnp.abs(intensity - prev_int)                        # [N]
        p2_adj = jnp.maximum(p1, p2 / grad)[:, None]                # [N, 1]

        # Normalize first: band-min over (prev - min) needs no trailing
        # "- prev_min" and turns the P2 term into a bare broadcast of
        # P2_adj (min(prev - m) == 0, so the P2 candidate is P2_adj
        # itself).  Same recurrence as semiglobal.cpp:146-152 with the
        # subtraction hoisted; the CUDA kernel (ops/sgm_cuda.cu) uses the
        # identical association so both paths round identically.
        prevn = prev - prev_min
        up = jnp.concatenate([jnp.full_like(prevn[:, :1], inf),
                              prevn[:, :-1]], axis=1)               # d-1
        down = jnp.concatenate([prevn[:, 1:],
                                jnp.full_like(prevn[:, :1], inf)], axis=1)

        band = jnp.minimum(jnp.minimum(prevn, up + p1),
                           jnp.minimum(down + p1, p2_adj))
        sgm = cost + band

        start = jnp.logical_or(jnp.logical_and(is_first, seed_first),
                               edge_start)                          # [N, 1]
        new_prev = jnp.where(start, cost, sgm)
        new_int = intensity
        return (new_prev, new_int), new_prev

    steps = cost_sv.shape[0]
    is_first = (lax.broadcasted_iota(jnp.int32, (steps, 1, 1), 0) == 0)
    is_first = jnp.broadcast_to(is_first, (steps, n, 1))

    if init_carry is None:
        init = (jnp.full(cost_sv.shape[1:], inf, jnp.float32),
                jnp.zeros((n,), jnp.float32))
    else:
        init = (init_carry[0].astype(jnp.float32),
                init_carry[1].astype(jnp.float32))
    final, contributions = lax.scan(step, init, (cost_sv, image_sv, is_first))
    return final, contributions


def _sgm_scan(cost_sv: jnp.ndarray, image_sv: jnp.ndarray,
              penalty1: float, penalty2: float,
              carry_shift: int) -> jnp.ndarray:
    """One full-axis SGM sweep (single chip); returns contributions only."""
    _, contributions = sgm_scan_with_carry(
        cost_sv, image_sv, penalty1, penalty2, carry_shift)
    return contributions


def _sweep_horizontal(cost, image, p1, p2, reverse):
    vol = jnp.swapaxes(cost, 0, 1)          # [W, H, D] — scan over W
    img = jnp.swapaxes(image, 0, 1)
    if reverse:
        vol, img = vol[::-1], img[::-1]
    out = _sgm_scan(vol, img, p1, p2, carry_shift=0)
    if reverse:
        out = out[::-1]
    return jnp.swapaxes(out, 0, 1)


def _sweep_vertical(cost, image, p1, p2, reverse):
    vol, img = cost, image                   # [H, W, D] — scan over H
    if reverse:
        vol, img = vol[::-1], img[::-1]
    out = _sgm_scan(vol, img, p1, p2, carry_shift=0)
    if reverse:
        out = out[::-1]
    return out


def _sweep_diagonal(cost, image, p1, p2, down_right, reverse):
    """Diagonal sweeps: scan over H with a carry shift along W.

    direction (1, 1): predecessor of (r, x) is (r-1, x-1)  -> shift +1.
    direction (-1, 1): predecessor of (r, x) is (r-1, x+1) -> shift -1.
    The inverse traversal of a (dx, 1) path is the (-dx, -1) walk, which a
    180-degree rotation maps back onto a (dx, 1) scan.
    """
    vol, img = cost, image
    if reverse:
        vol, img = vol[::-1, ::-1], img[::-1, ::-1]
    out = _sgm_scan(vol, img, p1, p2, carry_shift=1 if down_right else -1)
    if reverse:
        out = out[::-1, ::-1]
    return out


@functools.partial(jax.jit, static_argnames=("penalty1", "penalty2"))
def semiglobal_aggregate(cost_volume: jnp.ndarray, left_image: jnp.ndarray, *,
                         penalty1: float = 0.1,
                         penalty2: float = 0.2) -> jnp.ndarray:
    """Aggregate a [H, W, D] cost volume along 8 SGM path directions.

    Equivalent to AggregationOps::RunSemiglobal (src/semiglobal.cpp:167-197):
    4 path families x {forward, inverse} accumulated into a zero-initialised
    output volume.
    """
    cost = cost_volume.astype(jnp.float32)
    image = left_image.astype(jnp.float32)

    out = _sweep_horizontal(cost, image, penalty1, penalty2, reverse=False)
    out += _sweep_horizontal(cost, image, penalty1, penalty2, reverse=True)
    out += _sweep_vertical(cost, image, penalty1, penalty2, reverse=False)
    out += _sweep_vertical(cost, image, penalty1, penalty2, reverse=True)
    out += _sweep_diagonal(cost, image, penalty1, penalty2,
                           down_right=True, reverse=False)
    out += _sweep_diagonal(cost, image, penalty1, penalty2,
                           down_right=True, reverse=True)
    out += _sweep_diagonal(cost, image, penalty1, penalty2,
                           down_right=False, reverse=False)
    out += _sweep_diagonal(cost, image, penalty1, penalty2,
                           down_right=False, reverse=True)
    return out.astype(cost_volume.dtype)
