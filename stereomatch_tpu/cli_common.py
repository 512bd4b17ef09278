"""String registries + pipeline factory shared by the CLIs.

Mirrors the reference (stereomatch/cli_common.py:9-52).
"""

from __future__ import annotations

from .aggregation import CostFilter, Semiglobal
from .cost import NCC, SAD, SSD, Birchfield, Census, SSDTexture
from .disparity_reduce import DynamicProgramming, WinnerTakesAll
from .pipeline import Pipeline

COST_METHODS = {
    "ssd": SSD,
    "ssd-texture": SSDTexture,
    "birchfield": Birchfield,
    "census": Census,               # beyond the reference's cost surface
    "sad": SAD,                     # beyond the reference's cost surface
    "ncc": NCC,                     # beyond the reference's cost surface
}

AGGREGATION_METHODS = {
    "sgm": Semiglobal,
    "cvf": CostFilter,              # beyond the reference's aggregation
                                    # surface (guided cost-volume filtering)
}

DISPARITY_METHODS = {
    "wta": WinnerTakesAll,
    "dyn": DynamicProgramming,
}

# CLI disparity-method name -> stream/parallel reducer name
# (stream.StreamingEstimator and parallel.* grew the long name first).
STREAM_REDUCERS = {
    "wta": "wta",
    "dyn": "dynamic_programming",
}


VOLUME_DTYPES = ("float32", "bfloat16", "int32")


def setup_runtime(device=None) -> None:
    """CLI start-up: select the JAX platform (``--device``) and place the
    persistent compilation cache (utils/compile_cache.py)."""
    import jax

    from .utils.compile_cache import enable_compile_cache
    if device:
        jax.config.update("jax_platforms", device)
    enable_compile_cache()


def create_pipeline(cost_method: str, disp_method: str,
                    aggr_method: str = None,
                    max_disparity: int = 32,
                    penalty1: float = 0.1, penalty2: float = 0.2,
                    cvf_radius: int = 8, cvf_eps: float = 1e-4,
                    cvf_subsample: int = 1,
                    census_window: int = 5,
                    backend: str = "auto",
                    volume_dtype: str = "float32") -> Pipeline:
    """Create a pipeline from method names.

    Available cost functions: ``list(COST_METHODS)``; disparity methods:
    ``list(DISPARITY_METHODS)``; aggregation methods:
    ``list(AGGREGATION_METHODS)`` (or None).

    ``penalty1``/``penalty2`` configure SGM, ``cvf_radius``/``cvf_eps``
    configure cvf, and ``census_window`` the census code window (each
    ignored by the other methods);
    ``backend`` selects the SGM implementation — the Hopper kernel or the
    XLA scans (see utils.backend.resolve_backend); ``volume_dtype`` is the
    cost volume's storage dtype — "bfloat16" halves the memory traffic of
    every volume pass (the recurrences still compute float32; accuracy
    bound in tests/test_bf16.py), "int32" is the reference's integer cost
    path (SSD only, no SGM).
    """
    import jax.numpy as jnp
    if volume_dtype not in VOLUME_DTYPES:
        raise ValueError(f"unknown volume_dtype {volume_dtype!r}; "
                         f"expected one of {VOLUME_DTYPES}")
    if volume_dtype == "int32" and aggr_method is not None:
        raise ValueError("int32 cost volumes do not support aggregation "
                         "(SGM's adaptive P2, semiglobal.cpp:137-138, and "
                         "cvf's windowed means are float quantities)")
    if aggr_method is not None and aggr_method not in AGGREGATION_METHODS:
        # .get() with a None default would silently run the config with
        # NO aggregation and label the results with the mistyped name —
        # a quietly wrong benchmark row (stm-eval passes user config
        # strings straight through here).
        raise ValueError(f"unknown aggregation method {aggr_method!r}; "
                         f"expected one of {sorted(AGGREGATION_METHODS)} "
                         "or None")
    aggregation_cls = AGGREGATION_METHODS.get(aggr_method, None)
    if aggregation_cls is None:
        aggregation = None
    else:
        # Every registry class accepts (penalty1, penalty2, backend) and
        # ignores what doesn't apply; class-specific knobs join here.
        kwargs = dict(penalty1=penalty1, penalty2=penalty2, backend=backend)
        if aggregation_cls is CostFilter:
            kwargs.update(radius=cvf_radius, eps=cvf_eps,
                          subsample=cvf_subsample)
            # Every registry cost family writes +inf at exactly the
            # wedge x < d (disparity_offset is 0 through this factory),
            # so the filter may take the wedge-structured fast path
            # (ops/cvf.py::_filter_body_wedge; ~28% faster at teddy).
            # The subsampled fast path keeps its own statistics.
            if cvf_subsample == 1:
                kwargs.update(wedge_offset=0)
        aggregation = aggregation_cls(**kwargs)

    disparity = DISPARITY_METHODS[disp_method]()

    cost_cls = COST_METHODS[cost_method]
    if cost_cls is NCC and volume_dtype == "int32":
        raise ValueError("ncc cost is a normalized float quantity; "
                         "volume_dtype int32 is not supported")
    if cost_cls is Census:
        cost = Census(max_disparity, window_size=census_window,
                      cost_volume_dtype=jnp.dtype(volume_dtype))
    elif cost_cls in (SSD, SAD):
        cost = cost_cls(max_disparity,
                        cost_volume_dtype=jnp.dtype(volume_dtype))
    elif cost_cls is NCC:
        cost = NCC(max_disparity, cost_volume_dtype=jnp.dtype(volume_dtype))
    else:
        cost = cost_cls(max_disparity)

    return Pipeline(cost, disparity, aggregation=aggregation)

