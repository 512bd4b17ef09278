"""Stage-level benchmark suite mirroring the reference's pytest-benchmark
groups (cost / aggregation / disparity_reduce, README.md:48-75).

Geometries follow the reference fixtures: cost benchmarks on a 512x256
pair at D=32 (tests/conftest.py:23,86), aggregation/reduce on the
full-resolution teddy shape 450x375 at D=128 (tests/conftest.py:58-78).

Timing: each benchmark body is one jitted program; after warm-up calls
(compilation), the median of ``--repeats`` calls that each end in
``block_until_ready`` (utils/benchmarking.py).  The roofline share is the
op's minimum memory traffic at the device's published bandwidth
(utils/devices.py) over its time; a large copy's achieved bandwidth is
measured in the same run and reported beside it.  Every run names the
device and the card's power limit, and fails without an accelerator.

Usage:
    python benchmarks/suite.py [--json OUT.json] [--repeats R] [--only S]
"""

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# Reference GPU numbers (BASELINE.md); None where the reference has no
# directly comparable benchmark.
REFERENCE_MS = {
    "ssd_cost_512x256_d32": 2.49,
    # The reference has no SAD benchmark (SAD is beyond its cost surface),
    # so the SAD row carries no reference ratio by design.
    "sad_cost_512x256_d32": None,
    "ssd_texture_512x256_d32": 7.29,
    "birchfield_cost_512x256_d32": 2.99,
    "sgm_450x375_d128": 6.99,
    "sgm_xla_450x375_d128": 6.99,
    "wta_450x375_d128": None,
    "argmin_baseline_450x375_d128": None,
    "dynprog_450x375_d128": 0.708,
    "pipeline_teddy_450x375_d128": 10.0,
    "pipeline_teddy_xla_450x375_d128": 10.0,
    "pipeline_batch4_teddy_d128": 40.0,   # 4x the single-frame estimate
}


def _vol_bytes(h, w, d, itemsize=4):
    return h * w * d * itemsize


# Speed-of-light HBM traffic model per benchmark: the minimum bytes each
# op must move (volume-sized reads/writes only; images and disparity maps
# are negligible beside the [H,W,D] volume).  Most stages are
# memory-bound, so pct_of_roofline = sol_ms(published bandwidth) /
# measured_ms says how far each is from the device's limit.
def _traffic_models():
    v1 = _vol_bytes(256, 512, 32)          # cost group
    v2 = _vol_bytes(375, 450, 128)         # teddy group
    v3 = _vol_bytes(1024, 1280, 256)       # HD group
    return {
        # cost kernels: write the volume once (input images are ~0.1%)
        "ssd_cost_512x256_d32": v1,
        "ssd_texture_512x256_d32": v1,
        "birchfield_cost_512x256_d32": v1,
        "census_cost_512x256_d32": v1,
        "sad_cost_512x256_d32": v1,
        # ZNCC streams six stacked statistic planes through the box
        # filter and writes the volume: ~7 volume-sized transfers.
        "zncc_cost_512x256_d32": 7 * v1,
        "ssd_cost_teddy_d128": v2,
        # one k=7 box pass over the leading axis: read + write the volume
        "box_sum_teddy_d128": 2 * v2,
        "box_sum_hd_1024x1280_d256": 2 * v3,
        # SGM: read the cost volume + write the aggregated volume
        "sgm_450x375_d128": 2 * v2,
        "sgm_xla_450x375_d128": 2 * v2,
        # bf16 in and out: half the f32 volume each way
        "sgm_hd_bf16_1024x1280_d256": v3,
        "sgm_xla_hd_bf16_1024x1280_d256": v3,
        # cvf (guided cost-volume filtering): same minimum — read + write
        # the volume (the implementation's intermediate box-filter planes
        # are what %SoL charges it for, exactly like SGM's 4 passes)
        "cvf_450x375_d128": 2 * v2,
        "cvf_masked_generic_450x375_d128": 2 * v2,
        # fast (subsampled) cvf: read + write + two low-res resample
        # passes over the volume
        "cvf_fast_s2_450x375_d128": 3 * v2,
        # reducers: read the volume, write [H, W] int32 (~1/D of it)
        "wta_450x375_d128": v2,
        "argmin_baseline_450x375_d128": v2,
        "dynprog_450x375_d128": v2,
        # pipeline: vol write (cost) + vol read+write (SGM) + vol read (WTA)
        "pipeline_teddy_450x375_d128": 4 * v2,
        "pipeline_teddy_xla_450x375_d128": 4 * v2,
        "pipeline_batch4_teddy_d128": 16 * v2,
        "pipeline_hd_1024x1280_d256": 4 * v3,
        # bf16 volumes: same passes at half the bytes
        "pipeline_teddy_bf16_450x375_d128": 2 * v2,
        "pipeline_hd_bf16_1024x1280_d256": 2 * v3,
        "pipeline_census_teddy_450x375_d128": 4 * v2,
        "pipeline_census_bf16_teddy_d128": 2 * v2,
        "pipeline_census_cvf_teddy_d128": 4 * v2,
        # + one more bf16 volume read (0.5 * v2 under this file's
        # f32-volume unit) for the sub-pixel one-hot sweep
        "pipeline_census_bf16_refined_teddy": 5 * v2 // 2,
        "pipeline_hd_census_bf16_d256": 2 * v3,
        # HD CVF: the XLA wedge path's 8 box passes, floor quoted as
        # read+write like the teddy row.
        "cvf_hd_1024x1280_d256": 2 * v3,
        "cvf_hd_bf16_1024x1280_d256": v3,
        "pipeline_hd_census_cvf_d256": 4 * v3,
        "pipeline_hd_census_cvf_bf16_d256": 2 * v3,
        # pyramid: full census pipeline on a volume 8x smaller per level
        # (4 volume-sized transfers); the band stages are compute-bound
        # streaming scans whose memory traffic is only images/codes/maps
        # (~8 [H, W] i32 arrays per level) — so %SoL is meaningless for
        # these rows and low values do NOT mean headroom.
        "pipeline_pyramid1_teddy_d128":
            4 * v2 // 8 + 8 * _vol_bytes(376, 450, 1),
        "pipeline_pyramid1_tuned_teddy_d128":
            4 * v2 // 8 + 8 * _vol_bytes(376, 450, 1),
        "pipeline_pyramid2_teddy_d128":
            4 * v2 // 64 + 8 * _vol_bytes(188, 226, 1)
            + 8 * _vol_bytes(376, 450, 1),
        "pipeline_pyramid2_hd_d256":
            4 * v3 // 64 + 8 * _vol_bytes(512, 640, 1)
            + 8 * _vol_bytes(1024, 1280, 1),
        # temporal tracked frame: images/codes/prev/disp only (compute-bound
        # band scan over the full range; %SoL not meaningful).
        "temporal_track_teddy_d128": 8 * _vol_bytes(375, 450, 1),
        "temporal_track_hd_d256": 8 * _vol_bytes(1024, 1280, 1),
        # refine: the sub-pixel one-hot reductions stream the volume once;
        # [H,W] maps are noise.
        "refine_median_subpixel_teddy_d128": v2,
        # speckle: disparity in, mask+fill out — everything else is
        # on-chip shifted compares.
        "speckle_filter_teddy_450x375": 2 * _vol_bytes(375, 450, 1),
        # wmf: disparity + guide in, median out; the window^2 one-hot
        # histogram accumulation over the bin axis is compute work
        # (window^2 * D ops/pixel), so %SoL vs memory is not the bound.
        "wmf_teddy_450x375_d128": 3 * _vol_bytes(375, 450, 1),
        # fgs: 3 iterations x (row + column) tridiagonal solves — six
        # sequential scan pairs over [H, W] planes; traffic is a few
        # plane passes, the bound is scan latency (like DP).
        "fgs_teddy_450x375": 8 * _vol_bytes(375, 450, 1),
    }


def measure_copy_bandwidth(repeats=20):
    """Achieved bytes/s of a large elementwise copy (1 GiB in, 1 GiB out):
    what a memory-bound op on this card can reach, beside the published
    peak."""
    import jax
    import jax.numpy as jnp

    from stereomatch_tpu.utils import benchmarking

    x = jnp.ones((256 * 1024 * 1024,), jnp.float32)
    fn = jax.jit(lambda a: a + jnp.float32(1))
    ms = benchmarking.summarize_ms(benchmarking.time_calls(
        fn, x, repeats=repeats))["median_ms"]
    return 2 * x.nbytes / (ms / 1e3)


def build_benchmarks():
    import jax
    import jax.numpy as jnp

    from stereomatch_tpu.ops.cost import (birchfield_cost_volume,
                                          census_hamming_cost_volume,
                                          sad_cost_volume, ssd_cost_volume,
                                          zncc_cost_volume)
    from stereomatch_tpu.cli_common import create_pipeline
    from stereomatch_tpu.ops.aggregation import semiglobal_aggregate
    from stereomatch_tpu.ops.cost import _box_sum
    from stereomatch_tpu.ops.cvf import guided_filter_aggregate
    from stereomatch_tpu.ops.disparity import (dynamic_programming,
                                               winner_takes_all)
    from stereomatch_tpu.texture import TextureImage
    from stereomatch_tpu.utils.backend import resolve_backend, semiglobal_fn

    # The SGM rows run the implementation ``backend="auto"`` picks (the
    # Hopper kernel on an H100); the ``*_xla_*`` rows run the XLA scans.
    aggregate = semiglobal_fn(resolve_backend("auto"))

    rng = np.random.default_rng(0)

    # Cost group geometry: 512x256, D=32.
    h1, w1, d1 = 256, 512, 32
    l1 = jax.device_put(rng.random((h1, w1), np.float32))
    r1 = jax.device_put(rng.random((h1, w1), np.float32))

    # Aggregation / reduce group geometry: teddy full-res, D=128.
    h2, w2, d2 = 375, 450, 128
    l2 = jax.device_put(rng.random((h2, w2), np.float32))
    r2 = jax.device_put(rng.random((h2, w2), np.float32))
    vol2 = jax.device_put(rng.random((h2, w2, d2), np.float32))

    def feedback(img, out):
        """Tiny data dependency so chained iterations serialize."""
        flat = out.astype(jnp.float32)
        while flat.ndim > 2:
            flat = flat[..., 0]
        return img + jnp.float32(1e-12) * flat

    benches = {}

    def cost_bench(fn):
        def body(carry):
            l, r = carry
            return feedback(l, fn(l, r)), r
        return body, (l1, r1)

    benches["ssd_cost_512x256_d32"] = cost_bench(
        lambda l, r: ssd_cost_volume(l, r, max_disparity=d1, kernel_size=7))
    benches["ssd_texture_512x256_d32"] = cost_bench(
        lambda l, r: ssd_cost_volume(
            TextureImage.from_array(l).sample_grid(),
            TextureImage.from_array(r).sample_grid(),
            max_disparity=d1, kernel_size=7))
    benches["birchfield_cost_512x256_d32"] = cost_bench(
        lambda l, r: birchfield_cost_volume(l, r, max_disparity=d1))
    benches["census_cost_512x256_d32"] = cost_bench(
        lambda l, r: census_hamming_cost_volume(l, r, max_disparity=d1))
    benches["sad_cost_512x256_d32"] = cost_bench(
        lambda l, r: sad_cost_volume(l, r, max_disparity=d1, kernel_size=7))
    benches["zncc_cost_512x256_d32"] = cost_bench(
        lambda l, r: zncc_cost_volume(l, r, max_disparity=d1, kernel_size=7))

    def vol_bench(fn):
        def body(carry):
            v, img = carry
            out = fn(v, img)
            flat = out.astype(jnp.float32)
            while flat.ndim > 2:
                flat = flat[..., 0]
            return v + jnp.float32(1e-12) * flat[:, :, None], img
        return body, (vol2, l2)

    benches["ssd_cost_teddy_d128"] = (cost_bench(
        lambda l, r: ssd_cost_volume(l, r, max_disparity=d2,
                                     kernel_size=7))[0], (l2, r2))
    benches["box_sum_teddy_d128"] = vol_bench(
        lambda v, img: _box_sum(v, 7, axes=(0,)))
    benches["sgm_450x375_d128"] = vol_bench(lambda v, img: aggregate(v, img))
    benches["sgm_xla_450x375_d128"] = vol_bench(semiglobal_aggregate)
    # The cvf row measures the stage as the pipeline actually runs it:
    # a volume whose invalid entries are the standard +inf wedge
    # (x < d, every registry cost family) filtered through the
    # wedge-structured path (cli_common passes wedge_offset=0).  The
    # generic row keeps the arbitrary-+inf masked path honest.
    wedge_np = np.asarray(vol2).copy()
    xw, dw = np.meshgrid(np.arange(w2), np.arange(d2), indexing="ij")
    wedge_np[:, xw < dw] = np.inf
    vol2_wedge = jax.device_put(wedge_np)

    def wedge_vol_bench(fn):
        def body(carry):
            v, img = carry
            out = fn(v, img)
            probe = jnp.where(jnp.isfinite(out[:, :, 0]),
                              out[:, :, 0].astype(jnp.float32), 0.0)
            return v + jnp.float32(1e-12) * probe[:, :, None], img
        return body, (vol2_wedge, l2)

    benches["cvf_450x375_d128"] = wedge_vol_bench(
        lambda v, img: guided_filter_aggregate(v, img, wedge_offset=0))
    benches["cvf_masked_generic_450x375_d128"] = wedge_vol_bench(
        lambda v, img: guided_filter_aggregate(v, img))
    benches["cvf_fast_s2_450x375_d128"] = wedge_vol_bench(
        lambda v, img: guided_filter_aggregate(v, img, subsample=2))
    benches["wta_450x375_d128"] = vol_bench(
        lambda v, img: winner_takes_all(v))
    benches["argmin_baseline_450x375_d128"] = vol_bench(
        lambda v, img: jnp.argmin(v, axis=2).astype(jnp.int32))
    benches["dynprog_450x375_d128"] = vol_bench(
        lambda v, img: dynamic_programming(v))

    # The headline pipeline as users build it (bench.py's program), on
    # the implementation "auto" picks and on the XLA scans.
    def pipeline_bench(backend):
        estimate = create_pipeline("ssd", "wta", "sgm", max_disparity=d2,
                                   backend=backend).estimate_fn()

        def body(carry):
            l, r = carry
            return feedback(l, estimate(l, r)), r
        return body, (l2, r2)

    benches["pipeline_teddy_450x375_d128"] = pipeline_bench("auto")
    benches["pipeline_teddy_xla_450x375_d128"] = pipeline_bench("xla")

    def pipe_bf16_body(carry):
        l, r = carry
        vol = ssd_cost_volume(l, r, max_disparity=d2, kernel_size=7,
                              cost_dtype=jnp.bfloat16)
        agg = aggregate(vol, l)
        disp = winner_takes_all(agg)
        return feedback(l, disp), r

    benches["pipeline_teddy_bf16_450x375_d128"] = (pipe_bf16_body, (l2, r2))

    # Census + SGM + WTA: the fastest full-quality config (the census
    # stage carries no k^2 window); no reference analogue.
    def pipe_census_body(carry):
        l, r = carry
        vol = census_hamming_cost_volume(l, r, max_disparity=d2)
        disp = winner_takes_all(aggregate(vol, l))
        return feedback(l, disp), r

    benches["pipeline_census_teddy_450x375_d128"] = (pipe_census_body,
                                                     (l2, r2))

    def pipe_census_bf16_body(carry):
        l, r = carry
        vol = census_hamming_cost_volume(l, r, max_disparity=d2,
                                         cost_dtype=jnp.bfloat16)
        disp = winner_takes_all(aggregate(vol, l))
        return feedback(l, disp), r

    benches["pipeline_census_bf16_teddy_d128"] = (pipe_census_bf16_body,
                                                  (l2, r2))

    # Census + guided cost-volume filtering + WTA: the scan-free
    # low-latency aggregation config (no SGM recurrence at all).
    def pipe_census_cvf_body(carry):
        l, r = carry
        vol = census_hamming_cost_volume(l, r, max_disparity=d2)
        # wedge_offset=0 as cli_common.create_pipeline wires it (census
        # writes +inf at exactly the x < d wedge).
        disp = winner_takes_all(guided_filter_aggregate(vol, l,
                                                        wedge_offset=0))
        return feedback(l, disp), r

    benches["pipeline_census_cvf_teddy_d128"] = (pipe_census_cvf_body,
                                                 (l2, r2))

    # The full production config: census bf16 volume + 8-path SGM + WTA
    # + 3x3 median + in one-hot sub-pixel (float32 output) — what
    # `stm-serve -cm census --dtype bfloat16` + refine=1 executes.
    from stereomatch_tpu.ops import refine as _refine

    def pipe_census_bf16_refined_body(carry):
        l, r = carry
        vol = census_hamming_cost_volume(l, r, max_disparity=d2,
                                         cost_dtype=jnp.bfloat16)
        agg = aggregate(vol, l)
        disp = _refine.median_filter_3x3.__wrapped__(winner_takes_all(agg))
        idx = jnp.clip(jnp.round(disp), 0, d2 - 1).astype(jnp.int32)
        out = _refine.subpixel_refine.__wrapped__(agg, idx)
        return feedback(l, out), r

    benches["pipeline_census_bf16_refined_teddy"] = (
        pipe_census_bf16_refined_body, (l2, r2))

    # Coarse-to-fine pyramid (pyramid.py): census+SGM+WTA at reduced
    # resolution and range, per-pixel census band refinement back up.
    # No reference analogue (the reference always searches full range at
    # full resolution).
    from stereomatch_tpu.pyramid import PyramidPipeline

    def pyramid_bench(levels, max_disparity, pair, **kwargs):
        pipe = PyramidPipeline(max_disparity, levels=levels, **kwargs)

        def body(carry):
            l, r = carry
            return feedback(l, pipe._estimate(l, r)), r
        return body, pair

    # Defaults are the round-3 sweep winners (band_radius=24,
    # band_kernel_size=5 — pyramid1 2.28% -> 1.09% bad-pixel, pyramid2
    # 3.70% -> 0.71%; benchmarks/pyramid_sweep_out.json); the "tuned"
    # row adds the recommended stronger coarse penalties (0.89% at
    # pyramid1).
    benches["pipeline_pyramid1_teddy_d128"] = pyramid_bench(1, d2, (l2, r2))
    benches["pipeline_pyramid1_tuned_teddy_d128"] = pyramid_bench(
        1, d2, (l2, r2), penalty1=0.2, penalty2=0.4)
    benches["pipeline_pyramid2_teddy_d128"] = pyramid_bench(2, d2, (l2, r2))

    # Temporal tracked-frame steady state (temporal.py): census band
    # around the previous frame's disparity + 3x3 median + drift stat.
    # The chain feeds each step's disparity to the next as the anchor,
    # exactly the video tracking loop's data flow.  No reference
    # analogue (its video loop runs the full pipeline per frame).
    from stereomatch_tpu.temporal import TemporalPipeline

    def temporal_bench(max_disparity, pair):
        pipe = TemporalPipeline(max_disparity)

        def body(carry):
            l, r, prev = carry
            disp, poor = pipe._track(l, r, prev)
            return feedback(l, poor), r, disp
        return body, (*pair, jnp.zeros(pair[0].shape, jnp.int32))

    benches["temporal_track_teddy_d128"] = temporal_bench(d2, (l2, r2))

    # Post-processing stages (ops/refine.py): 3x3 median + parabolic
    # sub-pixel on the aggregated volume, and windowed-support speckle
    # suppression.  No reference analogue (its pipeline stops at integer
    # WTA/DP output).
    from stereomatch_tpu.ops import refine

    disp0 = jax.device_put(
        rng.integers(0, d2, (h2, w2)).astype(np.int32))

    def refine_body(carry):
        vol, disp = carry
        out = refine.median_filter_3x3.__wrapped__(disp)
        idx = jnp.clip(jnp.round(out), 0, d2 - 1).astype(jnp.int32)
        out = refine.subpixel_refine.__wrapped__(vol, idx)
        return vol, disp + (out < -1).astype(jnp.int32)

    benches["refine_median_subpixel_teddy_d128"] = (refine_body,
                                                    (vol2, disp0))

    def speckle_body(carry):
        (disp,) = carry
        out = refine.filter_speckles.__wrapped__(disp.astype(jnp.float32))
        return (disp + (out < -1).astype(jnp.int32),)

    benches["speckle_filter_teddy_450x375"] = (speckle_body, (disp0,))

    guide0 = jax.device_put(rng.random((h2, w2), np.float32))

    def wmf_body(carry):
        disp, guide = carry
        out = refine.weighted_median_filter.__wrapped__(
            disp, guide, window=5, sigma=0.1, n_bins=d2)
        return disp + (out < -1).astype(jnp.int32), guide

    benches["wmf_teddy_450x375_d128"] = (wmf_body, (disp0, guide0))

    def fgs_body(carry):
        disp, guide = carry
        out = refine.fgs_smooth.__wrapped__(
            disp.astype(jnp.float32), guide, lam=128.0, sigma_color=0.03)
        return disp + (out < -1).astype(jnp.int32), guide

    benches["fgs_teddy_450x375"] = (fgs_body, (disp0, guide0))

    # Batched video steady state: 4 frames per step, sequentially mapped
    # inside one jit (stream.StreamingEstimator's compute path).  Reported
    # per BATCH — divide by 4 for per-frame.
    lb = jax.device_put(rng.random((4, h2, w2), np.float32))
    rb = jax.device_put(rng.random((4, h2, w2), np.float32))

    def frame(l, r):
        vol = ssd_cost_volume(l, r, max_disparity=d2, kernel_size=7)
        return winner_takes_all(aggregate(vol, l))

    def batch_body(carry):
        l, r = carry
        disp = jax.lax.map(lambda p: frame(*p), (l, r))
        return l + jnp.float32(1e-12) * disp.astype(jnp.float32), r

    benches["pipeline_batch4_teddy_d128"] = (batch_body, (lb, rb))

    # Production-scale geometry: HD-class pair, D=256 (1.3 GB f32 volume).
    # No reference comparison — the CUDA benchmarks stop at teddy size.
    h3, w3, d3 = 1024, 1280, 256
    l3 = jax.device_put(rng.random((h3, w3), np.float32))
    r3 = jax.device_put(rng.random((h3, w3), np.float32))

    def hd_body(carry):
        l, r = carry
        vol = ssd_cost_volume(l, r, max_disparity=d3, kernel_size=7)
        disp = winner_takes_all(aggregate(vol, l))
        return feedback(l, disp), r

    benches["pipeline_hd_1024x1280_d256"] = (hd_body, (l3, r3))

    def hd_bf16_body(carry):
        l, r = carry
        vol = ssd_cost_volume(l, r, max_disparity=d3, kernel_size=7,
                              cost_dtype=jnp.bfloat16)
        disp = winner_takes_all(aggregate(vol, l))
        return feedback(l, disp), r

    benches["pipeline_hd_bf16_1024x1280_d256"] = (hd_bf16_body, (l3, r3))

    def hd_census_bf16_body(carry):
        l, r = carry
        vol = census_hamming_cost_volume(l, r, max_disparity=d3,
                                         cost_dtype=jnp.bfloat16)
        disp = winner_takes_all(aggregate(vol, l))
        return feedback(l, disp), r

    benches["pipeline_hd_census_bf16_d256"] = (hd_census_bf16_body,
                                               (l3, r3))

    def hd_vol_bench(fn, vol):
        def body(carry):
            v, img = carry
            out = fn(v, img)
            return v + (jnp.asarray(1e-12, v.dtype)
                        * out[:, :, :1].astype(v.dtype)), img
        return body, (vol, l3)

    vol3_bf16 = jax.device_put(jnp.asarray(
        rng.random((h3, w3, d3), np.float32), jnp.bfloat16))
    benches["sgm_hd_bf16_1024x1280_d256"] = hd_vol_bench(aggregate,
                                                         vol3_bf16)
    benches["sgm_xla_hd_bf16_1024x1280_d256"] = hd_vol_bench(
        semiglobal_aggregate, vol3_bf16)
    benches["box_sum_hd_1024x1280_d256"] = hd_vol_bench(
        lambda v, img: _box_sum(v, 7, axes=(0,)),
        jax.device_put(rng.random((h3, w3, d3), np.float32)))

    # HD CVF rows: the production geometry of the CVF configs.  The
    # stage row holds a wedge HD volume as carry; the pipeline rows
    # run census + CVF + WTA like the teddy flagship.
    wedge_hd = np.asarray(
        rng.random((h3, w3, d3), np.float32), np.float32)
    xw3, dw3 = np.meshgrid(np.arange(w3), np.arange(d3),
                           indexing="ij")
    wedge_hd[:, xw3 < dw3] = np.inf
    for dt, nm in ((jnp.float32, ""), (jnp.bfloat16, "_bf16")):
        vol3 = jax.device_put(jnp.asarray(wedge_hd, dt))

        def cvf_hd_body(carry, dt=dt):
            v, img = carry
            out = guided_filter_aggregate(v, img, wedge_offset=0)
            probe = jnp.where(jnp.isfinite(out[:, :, 0]),
                              out[:, :, 0].astype(jnp.float32), 0.0)
            return v + jnp.asarray(1e-12, dt) * probe[:, :, None].astype(
                dt), img

        benches[f"cvf_hd{nm}_1024x1280_d256"] = (cvf_hd_body,
                                                 (vol3, l3))

        def hd_census_cvf_body(carry, dt=dt):
            l, r = carry
            vol = census_hamming_cost_volume(l, r, max_disparity=d3,
                                             cost_dtype=dt)
            agg = guided_filter_aggregate(vol, l, wedge_offset=0)
            disp = winner_takes_all(agg)
            return feedback(l, disp), r

        benches[f"pipeline_hd_census_cvf{nm}_d256"] = (
            hd_census_cvf_body, (l3, r3))
    del wedge_hd
    benches["pipeline_pyramid2_hd_d256"] = pyramid_bench(2, d3, (l3, r3))
    benches["temporal_track_hd_d256"] = temporal_bench(d3, (l3, r3))
    return benches


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--json", default=None)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--only", default=None,
                        help="substring filter on benchmark names")
    args = parser.parse_args()

    import jax

    from stereomatch_tpu.utils import benchmarking
    from stereomatch_tpu.utils.compile_cache import enable_compile_cache
    from stereomatch_tpu.utils.devices import device_spec

    enable_compile_cache()
    benchmarking.require_accelerator()
    device = benchmarking.device_record()
    card = benchmarking.card()
    peak = device_spec(device["kind"]).hbm_bytes_per_s
    copy_bps = measure_copy_bandwidth()
    print(f"# device: {device}; card: {card}", file=sys.stderr)
    print(f"# published memory bandwidth {peak / 1e9:.0f} GB/s; a 1 GiB "
          f"copy reached {copy_bps / 1e9:.0f} GB/s", file=sys.stderr)
    traffic = _traffic_models()
    header = (f"{'benchmark':36s} {'ms':>9s} {'ref ms':>8s} {'speedup':>8s}"
              f" {'GB':>7s} {'%peak':>6s}")
    print(header, file=sys.stderr)
    results = {}
    for name, (body, init) in build_benchmarks().items():
        if args.only and args.only not in name:
            continue
        step = benchmarking.summarize_ms(benchmarking.time_calls(
            jax.jit(body), init, repeats=args.repeats))
        ms = step["median_ms"]
        ref = REFERENCE_MS.get(name)
        speed = f"{ref / ms:8.2f}" if ref else "       -"
        min_bytes = traffic.get(name)
        sol_ms = min_bytes / peak * 1e3 if min_bytes else None
        pct = 100.0 * sol_ms / ms if sol_ms else None
        print(f"{name:36s} {ms:9.3f} {ref if ref else float('nan'):8.3f}"
              f" {speed} {min_bytes / 1e9 if min_bytes else 0:7.3f}"
              f" {pct if pct else float('nan'):6.1f}", file=sys.stderr)
        results[name] = {
            "ms": round(ms, 4), "q1_ms": round(step["q1_ms"], 4),
            "q3_ms": round(step["q3_ms"], 4), "reference_ms": ref,
            "speedup_vs_reference": round(ref / ms, 3) if ref else None,
            "min_bytes_moved": min_bytes,
            "sol_ms_at_published_bw": (round(sol_ms, 4)
                                       if sol_ms is not None else None),
            "pct_of_roofline": round(pct, 1) if pct is not None else None,
        }

    payload = {"device": device, "card": card,
               "published_hbm_gbps": round(peak / 1e9, 1),
               "measured_copy_gbps": round(copy_bps / 1e9, 1),
               "results": results}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
