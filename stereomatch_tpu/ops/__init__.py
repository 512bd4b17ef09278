"""Functional, jittable kernels (the compute path).

These are the equivalents of the reference's native kernel layer
(src/*.cu, src/semiglobal.cpp); the class-based API in the package root wraps
them with the reference's Python surface.
"""

from .aggregation import semiglobal_aggregate
from .cost import (birchfield_cost_volume, census_hamming_cost_volume,
                   census_transform, ssd_cost_volume,
                   ssd_texture_cost_volume)
from .disparity import (dynamic_programming, dynamic_programming_with_paths,
                        winner_takes_all)
from .refine import (confidence_pkrn, fgs_smooth, fill_inconsistent,
                     left_right_consistency, median_filter_3x3,
                     right_disparity, right_disparity_from_volume,
                     right_volume_from_left, subpixel_refine,
                     weighted_median_filter)

__all__ = [
    "birchfield_cost_volume",
    "census_hamming_cost_volume",
    "census_transform",
    "confidence_pkrn",
    "dynamic_programming",
    "dynamic_programming_with_paths",
    "fgs_smooth",
    "fill_inconsistent",
    "left_right_consistency",
    "median_filter_3x3",
    "right_disparity",
    "right_disparity_from_volume",
    "right_volume_from_left",
    "semiglobal_aggregate",
    "ssd_cost_volume",
    "ssd_texture_cost_volume",
    "subpixel_refine",
    "weighted_median_filter",
    "winner_takes_all",
]
