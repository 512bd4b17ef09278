"""Device-mesh construction for the stereo pipeline.

Mesh axes:
  * ``batch`` — data parallelism over independent stereo frames (video
    batching, also across hosts).  No communication crosses this axis.
  * ``tile``  — spatial parallelism over image rows (the H axis of the
    [H, W, D] cost volume).  Halo exchange and SGM carry hand-off ride this
    axis, so it should stay within one host, where the cards are joined
    all to all (NVLink on the H100: every pair at the same rate, so the
    tile order needs no topology-aware layout).

The disparity axis D is deliberately *not* sharded: it is the innermost
axis of every kernel, and the SGM/DP recurrences reduce over it each
step (semiglobal.cpp:146-152) — sharding it would put a collective inside
every scan step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

BATCH_AXIS = "batch"
TILE_AXIS = "tile"


def batch_tile_axes(n_devices: int, n_batch: Optional[int] = None):
    """Pick a (batch, tile) factorization of ``n_devices``.

    Defaults to the largest power-of-two batch axis that still leaves at
    least 2 tiles when possible; single-device meshes are (1, 1).
    """
    if n_batch is not None:
        if n_devices % n_batch:
            raise ValueError(
                f"n_batch={n_batch} does not divide n_devices={n_devices}")
        return n_batch, n_devices // n_batch
    if n_devices == 1:
        return 1, 1
    n_batch = 1
    while (n_devices // n_batch) % 2 == 0 and (n_devices // n_batch) > 4:
        n_batch *= 2
    return n_batch, n_devices // n_batch


def initialize_distributed(**kwargs) -> None:
    """Multi-host process bootstrap (idempotent).

    Thin wrapper over ``jax.distributed.initialize`` so multi-host video
    configs need no extra plumbing; single-process runs skip it.

    NOTE: must run before anything initializes the XLA backend —
    *importing stereomatch_tpu already does*, so multi-process entry
    points should call ``jax.distributed.initialize`` before their first
    stereomatch_tpu import (see tests/distributed_worker.py,
    benchmarks/scaling.py); this helper is for code that already runs
    inside an initialized runtime and wants idempotence.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as err:
        # jax's actual message for a second initialize is "distributed.
        # initialize should only be called once"; treat that as the
        # idempotent re-entry case.  "must be called before any JAX
        # calls" fires when the backend already exists — also fine for
        # this helper's single-runtime use (the runtime is up; there is
        # no distributed state to create).
        msg = str(err).lower()
        if "only be called once" in msg or "must be called before" in msg:
            return
        raise
    except ValueError:
        # Single process without a coordinator/cluster environment —
        # fine: jax.devices() is usable without distributed state.
        pass


def make_hybrid_mesh(n_batch_hosts: Optional[int] = None,
                     n_tile: Optional[int] = None) -> Mesh:
    """(batch, tile) mesh across hosts: batch spans hosts, tile stays in one.

    Frames are data-parallel across hosts (the ``batch`` axis carries no
    collectives, so host-to-host latency never sits on the compute path),
    while each host's devices split image rows.  Falls back to
    :func:`make_mesh` in a single-host process.
    """
    from jax.experimental import mesh_utils

    n_hosts = jax.process_count()
    if n_hosts == 1:
        return make_mesh(n_batch=n_batch_hosts, n_tile=n_tile)
    per_host = jax.local_device_count()
    if n_tile is None:
        n_tile = per_host
    if n_batch_hosts is None:
        n_batch_hosts = (n_hosts * per_host) // n_tile
    try:
        grid = mesh_utils.create_hybrid_device_mesh(
            (1, n_tile), (n_batch_hosts, 1),
            devices=jax.devices())
    except ValueError:
        # Devices without slice topology (e.g. multi-process CPU runtimes):
        # group by process so the tile axis stays host-local — same layout
        # intent, no slice metadata needed.
        devs = sorted(jax.devices(),
                      key=lambda d: (d.process_index, d.id))
        grid = np.asarray(devs)
    return Mesh(grid.reshape(n_batch_hosts, n_tile),
                (BATCH_AXIS, TILE_AXIS))


def make_mesh(devices: Optional[Sequence] = None,
              n_batch: Optional[int] = None,
              n_tile: Optional[int] = None) -> Mesh:
    """Build a (batch, tile) mesh over the given (default: all) devices.

    The tile axis is contiguous in device order; each mesh position holds
    a distinct device.
    """
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    n = len(devices)
    if n_tile is not None and n_batch is None:
        if n % n_tile:
            raise ValueError(f"n_tile={n_tile} does not divide {n} devices")
        n_batch = n // n_tile
    n_batch, n_tile = batch_tile_axes(n, n_batch)
    grid = np.asarray(devices).reshape(n_batch, n_tile)
    return Mesh(grid, (BATCH_AXIS, TILE_AXIS))
