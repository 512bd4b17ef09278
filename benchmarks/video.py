"""End-to-end video throughput: Y4M file -> disparity stream, wall clock.

The stage suite (benchmarks/suite.py) isolates device compute per stage,
and benchmarks/serving.py measures the HTTP face.  This closes the
remaining gap: the `stm-video` experience — file decode, side-by-side
split, batched upload, device compute, the result fetch per batch, and
in-order frame yield — as one wall-clock
frames/s number per batch size (reference loop being matched:
/root/reference/stereomatch/cli_video.py:77-124, which re-uploads and
synchronizes every frame; StreamingEstimator instead keeps one batch in
flight).

A temporally coherent synthetic sequence (io.synthetic.stereo_sequence)
is written to a real Y4M file first, so the decode cost measured is the
same native-code path `stm-video y4m ...` uses.

Usage:
    python benchmarks/video.py [--batches 1,8] [--frames 64]
                               [--config census-bf16|ssd-f32]
                               [--json OUT.json] [--force-cpu]
"""

import argparse
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _write_sequence(path, height, width, max_disparity, n_frames):
    from stereomatch_tpu.io.synthetic import stereo_sequence
    from stereomatch_tpu import native
    frames = stereo_sequence(height, width, max_disparity, n_frames)
    sbs = np.stack([
        np.concatenate([np.clip(l * 255, 0, 255), np.clip(r * 255, 0, 255)],
                       axis=1).astype(np.uint8)
        for l, r, _ in frames])
    native.write_y4m(path, sbs)
    return sbs


def bench_config(y4m_path, sbs, batch, max_disparity, config, depth=2,
                 fetch_workers=4):
    import jax.numpy as jnp
    from stereomatch_tpu.io.capture import Y4MCapture
    from stereomatch_tpu.stream import StreamingEstimator

    kwargs = dict(cost="census", cost_dtype=jnp.bfloat16) \
        if config == "census-bf16" else dict(cost="ssd",
                                             cost_dtype=jnp.float32)
    est = StreamingEstimator(max_disparity, batch=batch, depth=depth,
                             fetch_workers=fetch_workers, **kwargs)

    # Warm the compile outside the timed window: one full batch through
    # estimate_batch, fetched.
    width = sbs.shape[2] // 2
    warm_l = sbs[:1, :, :width].repeat(est.batch, axis=0)
    warm_r = sbs[:1, :, width:].repeat(est.batch, axis=0)
    np.asarray(est.estimate_batch(warm_l, warm_r))

    cap = Y4MCapture(y4m_path)
    n_out = 0
    t0 = time.perf_counter()
    for _left, disp in est.run(cap):
        n_out += 1
    wall = time.perf_counter() - t0
    cap.close()
    assert n_out == sbs.shape[0], (n_out, sbs.shape[0])
    return {
        "frames": n_out,
        "wall_s": round(wall, 3),
        "fps": round(n_out / wall, 2),
        "ms_per_frame": round(wall / n_out * 1e3, 2),
        # Per-stage wall-clock split (decode / dispatch / fetch / other),
        # ms per frame: where the wall clock goes.
        "stage_ms_per_frame": est.stats.stage_ms_per_frame(),
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batches", default="1,8",
                        help="comma-separated StreamingEstimator batch sizes")
    parser.add_argument("--frames", type=int, default=64)
    parser.add_argument("--height", type=int, default=375)
    parser.add_argument("--width", type=int, default=450)
    parser.add_argument("--max-disparity", type=int, default=128)
    parser.add_argument("--config", default="census-bf16",
                        choices=("census-bf16", "ssd-f32"))
    parser.add_argument("--json", default=None)
    parser.add_argument("--depth", type=int, default=2,
                        help="batches kept in flight by the stream loop "
                             "(2 = overlap one batch's compute with the "
                             "next batch's decode)")
    parser.add_argument("--fetch-workers", default="4",
                        help="comma-separated result-fetch pool sizes to "
                             "sweep (effective concurrency is min(N, "
                             "depth), so depth is raised to N+1 "
                             "automatically when N > 1)")
    parser.add_argument("--force-cpu", action="store_true",
                        help="logic check on the CPU backend (the "
                             "result names the CPU as its device)")
    args = parser.parse_args()

    import jax

    from stereomatch_tpu.utils import benchmarking
    from stereomatch_tpu.utils.compile_cache import enable_compile_cache
    if args.force_cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        enable_compile_cache()
        benchmarking.require_accelerator()
    device = benchmarking.device_record()

    with tempfile.TemporaryDirectory() as tmp:
        y4m = pathlib.Path(tmp) / "stream.y4m"
        sbs = _write_sequence(y4m, args.height, args.width,
                              args.max_disparity, args.frames)
        results = {}
        workers = [int(n) for n in args.fetch_workers.split(",")]
        for batch in (int(b) for b in args.batches.split(",")):
            for fw in workers:
                depth = max(args.depth, fw + 1) if fw > 1 else args.depth
                name = (f"batch{batch}" if len(workers) == 1
                        else f"batch{batch}_fw{fw}")
                print(f"# measuring --batch {batch} fetch-workers {fw} "
                      f"(depth {depth}) ...", file=sys.stderr)
                results[name] = bench_config(
                    y4m, sbs, batch, args.max_disparity, args.config,
                    depth=depth, fetch_workers=fw)
                results[name]["fetch_workers"] = fw
                results[name]["depth"] = depth
                print(f"#   {results[name]}", file=sys.stderr)

    payload = {"device": device, "card": benchmarking.card(),
               "frame": f"{args.height}x{args.width}xD{args.max_disparity}",
               "config": f"{args.config} sgm-wta",
               "y4m_frames": args.frames,
               "results": results}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
