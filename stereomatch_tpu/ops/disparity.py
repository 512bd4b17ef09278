"""Disparity reducers: cost volume [H, W, D] -> disparity image [H, W] int32.

Array-level re-design of the reference reducers:

* Winner-takes-all — reference ``src/winners_take_all.cu:89-115``.  The CPU
  kernel is a linear argmin with ties broken toward the LOWER disparity
  (winners_take_all.cu:29-37); the CUDA tree reduction breaks ties the other
  way and needs a power-of-two D.  ``jnp.argmin`` over the D axis gives the
  CPU/lowest-index semantics with no power-of-two constraint, so that is the
  contract here (the reference's own equivalence tests sidestep the ambiguity
  with all-distinct volumes, tests/test_winners_take_all.py:31-33).

* Dynamic programming — reference ``src/dynamic_programming.cu:184-225``:
  a per-row forward pass accumulating
      acc[col, d] = C[col, d] + min(acc[col-1, d-1], acc[col-1, d],
                                    acc[col-1, d+1])
  while recording int8 back-pointers in {-1, 0, +1}
  (dynamic_programming.cu:38-62), then per-row argmin over the final column,
  then a right-to-left walk of the pointers with the disparity clamped to
  [0, D-1] (dynamic_programming.cu:166-181).  Here the forward pass is one
  ``lax.scan`` over W with an [H, D]-vectorized carry and the trace-back a
  second (reversed) scan with an [H]-vectorized carry.

Back-pointer tie-breaking replicates the reference's comparison chain
(dynamic_programming.cu:50-59) exactly:
    -1 if c(d-1) <  c(d) and c(d-1) < c(d+1)
     0 elif c(d)  <  c(d+1)
    +1 otherwise.

Deviation (documented): the reference writes the column-0 back-pointers
through transposed indices ([disp][row][0] at dynamic_programming.cu:31,100
vs [row][col][disp] everywhere else), so the cells the trace-back actually
reads at column 0 hold uninitialized ``torch.empty`` memory.  Here column 0's
back-pointers are defined as 0, the intended no-predecessor value.
"""

from __future__ import annotations

import jax
import numpy as np

import jax.numpy as jnp
from jax import lax

# np.float32 (not jnp.float32): identical f32 promotion, but a jnp
# scalar is a device array whose construction initializes the backend
# at IMPORT time (tests/test_import_hygiene.py).
_INF = np.float32(np.inf)


@jax.jit
def winner_takes_all(cost_volume: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel argmin over disparity; ties -> lower disparity. int32 [H, W]."""
    return jnp.argmin(cost_volume, axis=2).astype(jnp.int32)


def dp_forward_chunk(cost_volume: jnp.ndarray, init_acc=None):
    """DP forward pass over a chunk of columns, exposing the accumulator.

    ``init_acc`` [H, D] is the accumulator after the column left of this
    chunk (hand-off from the neighboring tile owner when the W axis is
    split); None marks the true scanline start, where column 0 seeds from
    the raw cost and gets back-pointer 0 (the reference's intended
    no-predecessor value, see module docstring).

    Returns (back-pointers int8 [H, Wc, D], final accumulator [H, D]).
    """
    height, width, max_disp = cost_volume.shape
    cost_sv = jnp.swapaxes(cost_volume, 0, 1)         # [W, H, D]

    def step(prev, cost_col):                          # prev: [H, D]
        c1 = jnp.concatenate([jnp.full_like(prev[:, :1], _INF),
                              prev[:, :-1]], axis=1)   # acc[d-1]
        c2 = prev
        c3 = jnp.concatenate([prev[:, 1:],
                              jnp.full_like(prev[:, :1], _INF)], axis=1)

        take1 = jnp.logical_and(c1 < c2, c1 < c3)
        take2 = c2 < c3
        direction = jnp.where(take1, jnp.int8(-1),
                              jnp.where(take2, jnp.int8(0), jnp.int8(1)))
        min_cost = jnp.where(take1, c1, jnp.where(take2, c2, c3))
        return cost_col + min_cost, direction

    if init_acc is None:
        init = cost_sv[0]                              # acc at col 0
        final, directions = lax.scan(step, init, cost_sv[1:])
        col0 = jnp.zeros((1, height, max_disp), jnp.int8)
        path = jnp.concatenate([col0, directions], axis=0)  # [W, H, D]
    else:
        final, path = lax.scan(step, init_acc.astype(cost_volume.dtype),
                               cost_sv)
    return jnp.swapaxes(path, 0, 1), final             # [H, Wc, D], [H, D]


def _dp_forward(cost_volume: jnp.ndarray):
    """Forward pass: returns (back-pointers int8 [H, W, D], final costs [H, D])."""
    return dp_forward_chunk(cost_volume)


def dp_backward_chunk(path_volume: jnp.ndarray, current: jnp.ndarray,
                      emit_current: bool):
    """Right-to-left pointer walk over a chunk of columns.

    ``current`` [H] is the disparity already decided for the column right
    of this chunk (the scanline end's argmin for the rightmost chunk).
    When ``emit_current`` (rightmost chunk), ``current`` itself is written
    at the last local column and the walk consumes pointer columns
    Wc-2..0; otherwise the walk consumes all Wc pointer columns and emits
    Wc disparities.  Returns (disparities int32 [H, Wc], outgoing current
    [H] — the leftmost decided disparity, the next chunk's ``current``).
    """
    height, width, max_disp = path_volume.shape
    cols = path_volume[:, :-1, :] if emit_current else path_volume
    path_sv = jnp.swapaxes(cols, 0, 1)[::-1]            # [n, H, D]

    # One-hot row selection instead of take_along_axis: exactly one
    # entry is selected, so the masked sum is the gathered value
    # bit-for-bit.  (Whether a gather is faster on the GPU is not
    # measured.)
    lane = lax.broadcasted_iota(jnp.int32, (height, max_disp), 1)

    def step(cur, path_col):                            # cur: [H]
        direction = jnp.sum(jnp.where(lane == cur[:, None],
                                      path_col.astype(jnp.int32), 0),
                            axis=1)
        new = jnp.clip(cur + direction, 0, max_disp - 1)
        return new, new

    current = current.astype(jnp.int32)
    out_cur, trace = lax.scan(step, current, path_sv)
    body = jnp.swapaxes(trace[::-1], 0, 1)              # [H, n]
    if emit_current:
        disp = jnp.concatenate([body, current[:, None]], axis=1)
    else:
        disp = body
    return disp, out_cur


def _dp_backward(path_volume: jnp.ndarray, end_disparities: jnp.ndarray):
    """Right-to-left pointer walk, vectorized over rows."""
    disp, _ = dp_backward_chunk(path_volume, end_disparities,
                                emit_current=True)
    return disp


@jax.jit
def dynamic_programming(cost_volume: jnp.ndarray) -> jnp.ndarray:
    """Scanline dynamic-programming disparity. int32 [H, W].

    Equivalent to DisparityReduceOps::RunDynamicProgramming
    (src/dynamic_programming.cu:184-225): forward band-min accumulation,
    per-row argmin of the final column (torch::argmin ties -> lowest index,
    matching jnp.argmin), then the back-pointer trace.
    """
    cost = cost_volume.astype(jnp.float32)
    path_volume, final_costs = _dp_forward(cost)
    end_disparities = jnp.argmin(final_costs, axis=1).astype(jnp.int32)
    return _dp_backward(path_volume, end_disparities)


def dynamic_programming_with_paths(cost_volume: jnp.ndarray):
    """Variant exposing the intermediate path volume and row-final costs.

    Mirrors the reference API surface where the caller pre-allocates
    ``path_volume`` and ``row_final_costs`` (stereomatch/disparity_reduce.py:77-84)
    and the native op fills them.
    """
    cost = cost_volume.astype(jnp.float32)
    path_volume, final_costs = _dp_forward(cost)
    end_disparities = jnp.argmin(final_costs, axis=1).astype(jnp.int32)
    disparity = _dp_backward(path_volume, end_disparities)
    return disparity, path_volume, final_costs
