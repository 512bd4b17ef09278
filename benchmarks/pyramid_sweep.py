"""Pyramid accuracy sweep: recover the coarse-to-fine mode's bad-pixel
gap vs the flat census+SGM pipeline.

Two free knobs on the band refinement stage, both compute-cheap:

* ``band_radius`` — the scan already runs the FULL disparity axis with
  masking (the gather-free formulation), so a wider band costs little;
* ``band_kernel_size`` — per-plane windowed Hamming (box-summed planes),
  giving the band WTA the neighborhood support the flat census cost's
  kernel_size provides.

Accuracy on the occlusion-aware synthetic scenes (exact GT, occlusions
masked) on CPU; the winning config's device time lands in the stage
suite.  Writes benchmarks/pyramid_sweep_out.json.

Usage: python benchmarks/pyramid_sweep.py [--scenes 6] [--levels 1 2]
"""

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenes", type=int, default=6)
    parser.add_argument("--size", default="192x256x64", metavar="HxWxD")
    parser.add_argument("--levels", type=int, nargs="+", default=[1, 2])
    parser.add_argument("--cpu", action="store_true", default=True)
    parser.add_argument("--json", default=None)
    args = parser.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from stereomatch_tpu.io.synthetic import stereo_pair_occluded
    from stereomatch_tpu.ops.aggregation import semiglobal_aggregate
    from stereomatch_tpu.ops.cost import census_hamming_cost_volume
    from stereomatch_tpu.ops.disparity import winner_takes_all
    from stereomatch_tpu.ops.refine import median_filter_3x3
    from stereomatch_tpu.pyramid import PyramidPipeline

    h, w, d = (int(v) for v in args.size.split("x"))
    scenes = [stereo_pair_occluded(h, w, d, seed=100 + i)
              for i in range(args.scenes)]

    def bad_pixel(disp, gt, occl):
        valid = ~occl
        valid[:, :d] = False
        return float(np.mean((np.abs(np.asarray(disp) - gt) > 1)[valid]))

    results = {}

    def record(name, rates):
        results[name] = round(float(np.mean(rates)), 5)
        print(f"{name:44s} bad={results[name]*100:6.2f}%", flush=True)

    # Flat census+SGM+WTA+median reference line.
    flat = []
    for left, right, gt, occl in scenes:
        vol = census_hamming_cost_volume(left, right, max_disparity=d)
        disp = median_filter_3x3(
            winner_takes_all(semiglobal_aggregate(vol, left)))
        flat.append(bad_pixel(disp, gt, occl))
    record("flat_census_sgm_median", flat)

    for levels in args.levels:
        for band_radius in (4, 8, 16, 24):
            for bks in (1, 5):
                pipe = PyramidPipeline(d, levels=levels,
                                       band_radius=band_radius,
                                       band_kernel_size=bks)
                rates = [bad_pixel(pipe._estimate(l, r), gt, occl)
                         for l, r, gt, occl in scenes]
                record(f"pyramid{levels}_r{band_radius}_bks{bks}", rates)
        # Stronger coarse penalties at the winning band config: the
        # coarse level is where unrecoverable misses originate, and it
        # tolerates more smoothing than the flat pipeline's defaults.
        pipe = PyramidPipeline(d, levels=levels, band_radius=24,
                               band_kernel_size=5,
                               penalty1=0.2, penalty2=0.4)
        rates = [bad_pixel(pipe._estimate(l, r), gt, occl)
                 for l, r, gt, occl in scenes]
        record(f"pyramid{levels}_r24_bks5_p2x", rates)

    payload = {"size": args.size, "scenes": args.scenes,
               "results": results}
    out = args.json or (pathlib.Path(__file__).parent
                        / "pyramid_sweep_out.json")
    with open(out, "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
