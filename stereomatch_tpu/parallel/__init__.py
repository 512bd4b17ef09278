"""Multi-device execution layer: device meshes, halo exchange, sharded
pipelines.

The reference implementation is single-process / single-GPU (SURVEY.md §2:
no distributed communication of any kind).  This package is the new-design
territory that makes the same algorithms span several devices:

* ``mesh``    — device-mesh construction over (batch, tile) axes: ``batch``
  data-parallel over stereo frames, ``tile`` spatial-parallel over image
  rows.
* ``halo``    — edge-row exchange between neighboring tile owners via
  ``lax.ppermute`` (the multi-device analogue of CUDA shared-memory
  aprons).
* ``sharded`` — shard_map'd cost / SGM / reduction pipeline with two
  scan-splitting strategies for the path recurrences that cross tile
  boundaries: exact sequential carry hand-off, and overlap warm-up
  (halo-initialized, linearly scaling).
"""

from .disp_sharded import make_disp_mesh, make_disp_sharded_wta
from .mesh import (batch_tile_axes, initialize_distributed,
                   make_hybrid_mesh, make_mesh)
from .pyramid_sharded import make_pyramid_sharded_estimate
from .sharded import ShardedPipeline, make_sharded_estimate
from .temporal_sharded import make_temporal_track_sharded
from .tiled2d import make_mesh_2d, make_tiled2d_estimate

__all__ = ["batch_tile_axes", "initialize_distributed", "make_disp_mesh",
           "make_disp_sharded_wta", "make_hybrid_mesh", "make_mesh",
           "make_mesh_2d", "make_pyramid_sharded_estimate",
           "make_temporal_track_sharded",
           "make_tiled2d_estimate", "ShardedPipeline",
           "make_sharded_estimate"]
