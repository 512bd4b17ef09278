"""Disparity-block sharding: split the D axis of cost + WTA across chips.

Complements the row-tiled pipeline (``sharded.py``).  The disparity axis is
deliberately *not* sharded under SGM/DP — their recurrences reduce over all
of D every scan step, so a D-shard would put a collective inside every step
(see docs/architecture.md).  For cost construction + winner-takes-all,
however, disparity blocks are embarrassingly parallel: each chip builds the
cost volume for its block [offset, offset + D/n) from the (replicated,
small) input images — no halos at all — and takes a local argmin.  The
global argmin is two tiny cross-device reductions over [H, W] maps:

    global_min  = pmin(local_min)
    disparity   = pmin(local_argmin where local_min == global_min else MAX)

which also reproduces the lowest-disparity tie-break of the single-chip
reducer exactly (the minimum over candidate indices is the lowest one).

This scales the memory footprint: a D=1024 volume that cannot fit one chip
runs with D/n per chip, and per-chip work drops linearly.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.cvf import guided_filter_aggregate
from ..ops.cost import (birchfield_cost_volume,
                        census_hamming_cost_volume,
                        sad_cost_volume, ssd_cost_volume,
                        zncc_cost_volume)

DISP_AXIS = "disp"


def make_disp_mesh(devices=None, n_disp: Optional[int] = None) -> Mesh:
    """1-axis mesh over the disparity dimension."""
    import numpy as np
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    if n_disp is None:
        n_disp = len(devices)
    return Mesh(np.asarray(devices[:n_disp]), (DISP_AXIS,))


def make_disp_sharded_wta(mesh: Mesh, *, max_disparity: int,
                          cost: str = "ssd",
                          kernel_size: Optional[int] = None,
                          cost_dtype=jnp.float32,
                          aggregation: Optional[str] = None,
                          cvf_radius: int = 8,
                          cvf_eps: float = 1e-4) -> Callable:
    """Compile cost + WTA with the disparity axis sharded over ``mesh``.

    Returns ``fn(left, right) -> disparity`` over [H, W] images (replicated
    to every chip; they are ~KBs against the volume's GBs).  Output matches
    the single-chip `winner_takes_all(cost(...))` bit-for-bit.
    """
    if cost not in ("ssd", "ssd-texture", "birchfield", "census", "sad",
                    "ncc"):
        raise ValueError(f"unknown cost {cost!r}")
    if aggregation not in (None, "cvf"):
        # SGM/DP recurrences reduce over ALL of D every scan step (see
        # module docstring) — cvf is the one aggregation with no cross-D
        # coupling at all, so it is the one that composes with D-blocks.
        raise ValueError(f"unknown aggregation {aggregation!r} (disparity "
                         "sharding supports None or 'cvf')")
    if kernel_size is None:
        kernel_size = {"birchfield": 4, "census": 1}.get(cost, 7)
    n_disp = mesh.shape[DISP_AXIS]
    if max_disparity % n_disp:
        raise ValueError(f"max_disparity {max_disparity} not divisible by "
                         f"disp axis {n_disp}")
    block = max_disparity // n_disp

    def local_fn(left, right):
        left = left.astype(jnp.float32)
        right = right.astype(jnp.float32)
        offset = lax.axis_index(DISP_AXIS) * block
        if cost in ("ssd", "ssd-texture"):
            vol = ssd_cost_volume(left, right, max_disparity=block,
                                  kernel_size=kernel_size,
                                  cost_dtype=cost_dtype,
                                  disparity_offset=offset)
        elif cost == "sad":
            vol = sad_cost_volume(left, right, max_disparity=block,
                                  kernel_size=kernel_size,
                                  cost_dtype=cost_dtype,
                                  disparity_offset=offset)
        elif cost == "ncc":
            # Full image per chip: window statistics are exactness-safe,
            # and the validity mask threads the global disparity_offset.
            # zncc's degenerate-geometry guard treats a TRACED offset as
            # 0 (ops/cost.py), relying on this partitioner's invariant
            # offset + block <= max_disparity <= W + 1; assert it here
            # at trace time (shapes are static) so a violating geometry
            # fails loudly instead of silently reading clamped prefix
            # columns.
            if max_disparity > left.shape[1] + 1:
                raise ValueError(
                    f"disparity-sharded ncc needs max_disparity "
                    f"{max_disparity} <= W + 1 = {left.shape[1] + 1} "
                    "(the traced per-chip offset would overrun the "
                    "[H, W+1] prefix plane)")
            vol = zncc_cost_volume(left, right, max_disparity=block,
                                   kernel_size=kernel_size,
                                   cost_dtype=cost_dtype,
                                   disparity_offset=offset)
        elif cost == "census":
            # Full image per chip (no spatial sharding), so the Hamming
            # box window is exactness-safe here, unlike the tiled paths.
            vol = census_hamming_cost_volume(left, right,
                                             max_disparity=block,
                                             kernel_size=kernel_size,
                                             cost_dtype=cost_dtype,
                                             disparity_offset=offset)
        else:
            vol = birchfield_cost_volume(left, right, max_disparity=block,
                                         kernel_size=kernel_size,
                                         disparity_offset=offset)
        vol = vol.astype(jnp.float32)
        if aggregation == "cvf":
            # Every guided-filter statistic is per-disparity-slice, so
            # each chip filtering its own D block (with its own +inf
            # wedge mask) IS the single-chip filter restricted to that
            # block — bit-exact, no collectives.
            vol = guided_filter_aggregate(vol, left, radius=cvf_radius,
                                          eps=cvf_eps)
        local_min = jnp.min(vol, axis=2)                      # [H, W]
        local_arg = (jnp.argmin(vol, axis=2).astype(jnp.int32)
                     + offset)                                # global d
        global_min = lax.pmin(local_min, DISP_AXIS)
        candidate = jnp.where(local_min == global_min, local_arg,
                              jnp.int32(2 ** 30))
        disparity = lax.pmin(candidate, DISP_AXIS)
        # Every chip now holds the full result; emit disjoint row slices
        # so the output spec is sharded, not "replicated".
        rows = disparity.shape[0] // n_disp
        idx = lax.axis_index(DISP_AXIS)
        return lax.dynamic_slice_in_dim(disparity, idx * rows, rows, axis=0)

    mapped = shard_map(local_fn, mesh=mesh,
                       in_specs=(P(None, None), P(None, None)),
                       out_specs=P(DISP_AXIS, None))
    replicated = NamedSharding(mesh, P(None, None))

    def fn(left, right):
        if left.shape[0] % n_disp:
            raise ValueError(f"height {left.shape[0]} not divisible by "
                             f"disp axis {n_disp} (output row slicing)")
        left = jax.device_put(jnp.asarray(left), replicated)
        right = jax.device_put(jnp.asarray(right), replicated)
        return mapped(left, right)

    return jax.jit(fn)
