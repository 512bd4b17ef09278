"""Headline benchmark: teddy-class SGM pipeline frames/s on one GPU.

Matches the reference's benchmark geometry (BASELINE.md): full-resolution
Middlebury *teddy* — 450x375 grayscale, D=128 cost volume — through the
full SSD -> 8-path SGM -> WTA pipeline, built by ``create_pipeline`` and
run as ONE jitted XLA program (``Pipeline.compiled()``), on the SGM
implementation ``backend="auto"`` picks (the Hopper kernel on an H100).

Baseline to beat: the reference CUDA GPU end-to-end estimate of ~10 ms/frame
(~100 fps): SSD 2.49 ms + SGM 6.99 ms + WTA (<1 ms) per README.md:48-75.

Measurement: warm-up calls (compilation is reported separately), then
``REPEATS`` calls each ending in ``block_until_ready``; the value is the
median.  Fails without an accelerator.

Prints one JSON line:
  {"metric": ..., "value": fps, "unit": "frames/s", "vs_baseline": fps/100,
   "frame_ms": {...}, "compile_s": ..., "kernel_build_s": ...,
   "backend": ...,
   "device": {"platform", "kind", "count"}, "card": "<name>, <power.limit>"}
"""

import json
import sys
import time


BASELINE_FPS = 100.0  # reference CUDA end-to-end (BASELINE.md)
HEIGHT, WIDTH, MAX_DISPARITY = 375, 450, 128
REPEATS = 50


def main():
    import jax

    from stereomatch_tpu.cli_common import create_pipeline
    from stereomatch_tpu.io.synthetic import stereo_pair
    from stereomatch_tpu.utils import benchmarking
    from stereomatch_tpu.utils.backend import resolve_backend
    from stereomatch_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    try:
        benchmarking.require_accelerator()
    except benchmarking.NoAcceleratorError as err:
        print(f"bench: {err}", file=sys.stderr)
        sys.exit(1)

    backend = resolve_backend("auto")
    start = time.perf_counter()
    if backend == "cuda":
        from stereomatch_tpu.ops import sgm_cuda
        sgm_cuda.build()                  # nvcc at first use: set-up time
    build_s = time.perf_counter() - start

    left, right, _ = stereo_pair(HEIGHT, WIDTH, MAX_DISPARITY, seed=0)
    left, right = jax.device_put(left), jax.device_put(right)
    pipe = create_pipeline("ssd", "wta", "sgm", max_disparity=MAX_DISPARITY)
    fn = pipe.compiled(donate=False)

    start = time.perf_counter()
    jax.block_until_ready(fn(left, right))
    compile_s = time.perf_counter() - start

    frame = benchmarking.summarize_ms(
        benchmarking.time_calls(fn, left, right, repeats=REPEATS))
    fps = 1e3 / frame["median_ms"]
    print(json.dumps({
        "metric": "teddy_sgm_pipeline_fps",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "frame_ms": {k: round(v, 4) for k, v in frame.items()},
        "compile_s": round(compile_s, 3),
        "kernel_build_s": round(build_s, 3),
        "backend": backend,
        "device": benchmarking.device_record(),
        "card": benchmarking.card(),
    }))


if __name__ == "__main__":
    main()
