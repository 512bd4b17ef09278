"""Aggregation API — class surface mirroring the reference
(stereomatch/aggregation.py:12-57)."""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from .ops.cvf import guided_filter_aggregate
from .utils import validation
from .utils.backend import resolve_backend, semiglobal_fn


class Semiglobal:
    """Semiglobal-matching aggregation (Hirschmuller 2005) over 8 path
    directions with an image-gradient-adaptive second penalty.

    Reference: stereomatch/aggregation.py:12-57.  (Its docstring claims 6
    directions; the code runs 4 families x forward/inverse = 8 traversals,
    src/semiglobal.cpp:18-91,191-194 — this implementation matches the code.)

    Unlike the CUDA version there is no power-of-two constraint on the
    disparity axis, and ``sga_volume=`` reuse arguments are accepted but
    ignored (buffer lifetime is XLA's under jit).
    """

    def __init__(self, penalty1: float = 0.1, penalty2: float = 0.2,
                 backend: str = "auto"):
        """
        Args:
            penalty1: cost penalty for changing disparity by one level.
            penalty2: base penalty for larger disparity jumps, scaled by the
              inverse image gradient (P2_adj = max(P1, P2 / |dI|)).
            backend: "cuda" (the Hopper kernel, ops/sgm_cuda.cu), "xla"
              (lax.scan formulation), or "auto" — cuda on a Hopper GPU,
              xla everywhere else.  Both compute the same 8-traversal
              aggregation in the same order (see utils/backend.py).
        """
        self.penalty1 = penalty1
        self.penalty2 = penalty2
        self.backend = backend

    def __call__(self, cost_volume, left_image,
                 sga_volume: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        cost_volume = jnp.asarray(cost_volume)
        left_image = jnp.asarray(left_image)
        validation.check_cost_volume(cost_volume)
        validation.check_rank("left_image", left_image, 2)
        if cost_volume.shape[:2] != left_image.shape:
            raise validation.ShapeError(
                f"cost_volume spatial dims {cost_volume.shape[:2]} do not "
                f"match left_image {left_image.shape}")
        aggregate = semiglobal_fn(resolve_backend(self.backend))
        return aggregate(cost_volume, left_image,
                         penalty1=float(self.penalty1),
                         penalty2=float(self.penalty2))


class CostFilter:
    """Guided-filter cost-volume aggregation (Hosni et al., PAMI 2013).

    Edge-aware *local* smoothing of every disparity slice with the left
    image as the filtering guide — the scan-free alternative to
    :class:`Semiglobal` (beyond the reference's aggregation surface,
    which is SGM only, stereomatch/aggregation.py:12-57).  Pure box
    filters and elementwise algebra: no sequential recurrence, so it is
    the low-latency aggregation and shards over image tiles with plain
    halos (see ops/cvf.py for the semantics, including +inf-invalid
    handling and bf16 storage).

    ``penalty1``/``penalty2``/``backend`` are accepted so the class is
    registry-compatible with :class:`Semiglobal` (cli_common.py factory)
    but do not apply: the method has no disparity-jump penalties, and
    its box filters are a single XLA formulation.
    """

    def __init__(self, radius: int = 8, eps: float = 1e-4,
                 subsample: int = 1,
                 penalty1: float = None, penalty2: float = None,
                 backend: str = "auto", wedge_offset=None):
        """
        Args:
            radius: box window half-size (support (2*radius+1)^2; the
              second filter stage doubles the effective reach).
            eps: edge-stop regularizer in image-intensity^2 units —
              larger smooths across weaker image edges.
            subsample: > 1 = Fast Guided Filter (statistics on an
              s x-downsampled grid; approximate, box work / s^2).
            penalty1/penalty2/backend: ignored (registry compatibility).
            wedge_offset: declare the volume's invalid set to be exactly
              the standard wedge ``x < d + wedge_offset`` — the masked
              guide statistics then collapse to plane algebra (~28%
              faster at teddy; ops/cvf.py::_filter_body_wedge).  Every
              registry cost family writes exactly this wedge, so
              cli_common.create_pipeline passes 0; leave None for
              volumes with arbitrary +inf patterns.
        """
        del penalty1, penalty2, backend
        self.radius = radius
        self.eps = eps
        self.subsample = subsample
        self.wedge_offset = wedge_offset

    def __call__(self, cost_volume, left_image,
                 sga_volume: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        cost_volume = jnp.asarray(cost_volume)
        left_image = jnp.asarray(left_image)
        validation.check_cost_volume(cost_volume)
        validation.check_rank("left_image", left_image, 2)
        if cost_volume.shape[:2] != left_image.shape:
            raise validation.ShapeError(
                f"cost_volume spatial dims {cost_volume.shape[:2]} do not "
                f"match left_image {left_image.shape}")
        if not jnp.issubdtype(cost_volume.dtype, jnp.floating):
            raise validation.DTypeError(
                "cost-volume filtering computes windowed means, a float "
                f"quantity; got cost volume dtype {cost_volume.dtype}")
        wedge = (None if self.wedge_offset is None
                 else int(self.wedge_offset))
        return guided_filter_aggregate(cost_volume, left_image,
                                       radius=int(self.radius),
                                       eps=float(self.eps),
                                       subsample=int(self.subsample),
                                       wedge_offset=wedge)
