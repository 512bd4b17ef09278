"""Disparity-reduce API — class surface mirroring the reference
(stereomatch/disparity_reduce.py:16-90)."""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from .ops.disparity import dynamic_programming, winner_takes_all
from .utils import validation


class WinnerTakesAll:
    """Argmin-over-disparity reducer (reference:
    stereomatch/disparity_reduce.py:16-46).

    Ties break toward the lower disparity (the reference CPU semantics,
    winners_take_all.cu:29-37).  The CUDA power-of-two-D restriction
    (disparity_reduce.py:40-43) does not apply here.
    """

    def __call__(self, cost_volume,
                 disparity_img: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        cost_volume = jnp.asarray(cost_volume)
        validation.check_cost_volume(cost_volume)
        return winner_takes_all(cost_volume)


class DynamicProgramming:
    """Scanline dynamic-programming reducer (reference:
    stereomatch/disparity_reduce.py:49-90).

    The reference allocates an int8 path volume and per-row final costs on
    the caller side (disparity_reduce.py:77-84); here those live inside the
    jitted kernel (see ops.disparity.dynamic_programming_with_paths for a
    variant exposing them).
    """

    def __call__(self, cost_volume,
                 disparity_img: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        cost_volume = jnp.asarray(cost_volume)
        validation.check_cost_volume(cost_volume)
        return dynamic_programming(cost_volume)
