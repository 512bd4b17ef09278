"""stereomatch_tpu — a classic stereo-matching engine on JAX.

A from-scratch JAX/XLA re-design with the capabilities of the reference
CUDA library (otaviog/stereo-matching): SSD and Birchfield-Tomasi cost
volumes, 8-path semiglobal aggregation (with a hand-written CUDA kernel
for NVIDIA Hopper GPUs, ops/sgm_cuda.cu), winner-takes-all and
dynamic-programming disparity reduction, composed into jit-compiled
pipelines that shard across device meshes.

Public surface mirrors the reference package layout
(stereomatch/__init__.py:1-4): cost / aggregation / disparity_reduce plus
texture (the sampling layer standing in for CUDA textures).
"""

from . import (aggregation, cli_common, cost, disparity_reduce, io, metrics,
               pipeline, pyramid, reconstruction, temporal, texture, utils)
from .pipeline import Pipeline
from .pyramid import PyramidPipeline
from .temporal import TemporalPipeline

__version__ = "0.1.0"

__all__ = ["Pipeline", "PyramidPipeline", "TemporalPipeline", "aggregation",
           "cli_common", "cost", "disparity_reduce", "io", "metrics",
           "pipeline", "pyramid", "reconstruction", "temporal", "texture",
           "utils", "__version__"]
