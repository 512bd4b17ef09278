"""Argument validation for the ops API.

Counterpart of the reference's native-side checking layer
(include/stereomatch/check.hpp:12-43 and src/type_dispatch.hpp:38-110).  The
reference validates device placement and dispatches over (input dtype x cost
dtype x device) in C++; under JAX, dtype polymorphism is native and device
placement is managed by the runtime, so what remains is *shape and dtype
contract* checking, done eagerly in Python before tracing so errors carry
useful messages instead of XLA shape mismatches.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp

# dtypes accepted for input images, mirroring the reference's
# STM_DISPATCH_COSTFUNC_TYPES input set (uint8 / int16 / float32)
# plus bfloat16.
IMAGE_DTYPES = (jnp.uint8, jnp.int16, jnp.float32, jnp.bfloat16)
# dtypes accepted for cost volumes (reference: int32 / float32).
COST_DTYPES = (jnp.int32, jnp.float32, jnp.bfloat16)


class ShapeError(ValueError):
    """Raised when an op receives arrays of the wrong rank/shape."""


class DTypeError(TypeError):
    """Raised when an op receives arrays of an unsupported dtype."""


def check_rank(name: str, arr, rank: int) -> None:
    if arr.ndim != rank:
        raise ShapeError(
            f"{name} must have rank {rank}, got shape {tuple(arr.shape)}")


def check_same_shape(name_a: str, a, name_b: str, b) -> None:
    if tuple(a.shape) != tuple(b.shape):
        raise ShapeError(
            f"{name_a} and {name_b} must have the same shape, got "
            f"{tuple(a.shape)} vs {tuple(b.shape)}")


def check_dtype(name: str, arr, allowed: Sequence) -> None:
    if not any(arr.dtype == jnp.dtype(d) for d in allowed):
        raise DTypeError(
            f"{name} has unsupported dtype {arr.dtype}; expected one of "
            f"{[jnp.dtype(d).name for d in allowed]}")


def check_stereo_pair(left, right) -> None:
    """Validate a rectified stereo pair of [H, W] images."""
    check_rank("left_image", left, 2)
    check_rank("right_image", right, 2)
    check_same_shape("left_image", left, "right_image", right)
    check_dtype("left_image", left, IMAGE_DTYPES)
    check_dtype("right_image", right, IMAGE_DTYPES)


def check_cost_volume(volume) -> None:
    """Validate a [H, W, D] cost volume."""
    check_rank("cost_volume", volume, 3)
    check_dtype("cost_volume", volume, COST_DTYPES)


def check_positive(name: str, value: int) -> None:
    if value <= 0:
        raise ValueError(f"{name} must be positive, got {value}")
