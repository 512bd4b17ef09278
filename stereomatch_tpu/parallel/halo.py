"""Halo (edge-row) exchange between neighboring tile owners.

Multi-device replacement for the CUDA kernels' shared-memory aprons: each
device owns a contiguous block of image rows, and window/scan operators that
reach across the block boundary pull the needed rows from the neighbor with
``lax.ppermute``.  All functions here are meant to run *inside* a
``shard_map`` body over the tile axis.

``ppermute`` fills zeros at ring ends (shard 0 has no predecessor), which is
exactly the additive-identity padding the clipped cost windows want
(ops/cost.py::_box_sum) and the cold-start identity the SGM warm-up scan
wants (parallel/sharded.py) — so no masking pass is needed for fill=0.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def pull_from_prev(x: jnp.ndarray, count: int, axis: int,
                   axis_name: str) -> jnp.ndarray:
    """Last ``count`` slices (along ``axis``) of the previous shard's block.

    Shard 0 receives zeros.  Shape matches ``x`` except ``axis`` has size
    ``count``.
    """
    n = lax.axis_size(axis_name)
    edge = lax.slice_in_dim(x, x.shape[axis] - count, x.shape[axis], axis=axis)
    if n == 1:
        return jnp.zeros_like(edge)
    return lax.ppermute(edge, axis_name,
                        perm=[(i, i + 1) for i in range(n - 1)])


def pull_from_next(x: jnp.ndarray, count: int, axis: int,
                   axis_name: str) -> jnp.ndarray:
    """First ``count`` slices (along ``axis``) of the next shard's block.

    The last shard receives zeros.
    """
    n = lax.axis_size(axis_name)
    edge = lax.slice_in_dim(x, 0, count, axis=axis)
    if n == 1:
        return jnp.zeros_like(edge)
    return lax.ppermute(edge, axis_name,
                        perm=[(i + 1, i) for i in range(n - 1)])


def pull_from_prev_multi(x: jnp.ndarray, count: int, axis: int,
                         axis_name: str) -> jnp.ndarray:
    """The ``count`` slices immediately BEFORE this shard's block, pulled
    from as many predecessors as needed (``count`` may exceed the local
    block, unlike :func:`pull_from_prev`).  Hop j contributes the tail of
    the block j ranks back; positions before shard 0 are zeros.  Result
    has size ``count`` along ``axis``, ordered as the global axis.
    """
    n = lax.axis_size(axis_name)
    local = x.shape[axis]
    hops = -(-count // local)
    parts = []
    for j in range(hops, 0, -1):                 # farthest rank first
        width = min(local, count - (j - 1) * local)
        edge = lax.slice_in_dim(x, local - width, local, axis=axis)
        if j >= n:
            parts.append(jnp.zeros_like(edge))
        else:
            parts.append(lax.ppermute(
                edge, axis_name, perm=[(i, i + j) for i in range(n - j)]))
    return jnp.concatenate(parts, axis=axis) if len(parts) > 1 else parts[0]


def pull_from_next_multi(x: jnp.ndarray, count: int, axis: int,
                         axis_name: str) -> jnp.ndarray:
    """The ``count`` slices immediately AFTER this shard's block, pulled
    from as many successors as needed (multi-hop counterpart of
    :func:`pull_from_next`).  Positions beyond the last shard are zeros.
    """
    n = lax.axis_size(axis_name)
    local = x.shape[axis]
    hops = -(-count // local)
    parts = []
    for j in range(1, hops + 1):                 # nearest rank first
        width = min(local, count - (j - 1) * local)
        edge = lax.slice_in_dim(x, 0, width, axis=axis)
        if j >= n:
            parts.append(jnp.zeros_like(edge))
        else:
            parts.append(lax.ppermute(
                edge, axis_name, perm=[(i + j, i) for i in range(n - j)]))
    return jnp.concatenate(parts, axis=axis) if len(parts) > 1 else parts[0]


def out_of_image_mask(axis_name: str, n_shards: int, local_len: int,
                      before: int, after: int = None) -> jnp.ndarray:
    """Which positions of a halo-extended block lie beyond the true image.

    Boolean ``[before + local_len + after]`` vector (``after`` defaults to
    ``before``): True where the global coordinate ``idx + rank*local_len -
    before`` falls outside ``[0, n_shards*local_len)`` — i.e. the ppermute
    ring-end zero fill.  Zero is the additive identity for window *sums*
    but not for window *counts*, so every count-normalized windowed
    statistic (ZNCC, guided cost-volume filtering) must exclude these
    positions; shared here so the bounds arithmetic lives in one place.
    """
    if after is None:
        after = before
    p = lax.axis_index(axis_name)
    idx = lax.broadcasted_iota(jnp.int32, (before + local_len + after,), 0)
    g = idx + p * local_len - before
    return (g < 0) | (g >= n_shards * local_len)


def pad_with_halos(x: jnp.ndarray, before: int, after: int, axis: int,
                   axis_name: str) -> jnp.ndarray:
    """Concatenate neighbor halos around this shard's block along ``axis``.

    Out-of-image positions (ring ends) are zero-filled.  ``before``/``after``
    may be 0.
    """
    parts = []
    if before:
        parts.append(pull_from_prev(x, before, axis, axis_name))
    parts.append(x)
    if after:
        parts.append(pull_from_next(x, after, axis, axis_name))
    if len(parts) == 1:
        return x
    return jnp.concatenate(parts, axis=axis)
