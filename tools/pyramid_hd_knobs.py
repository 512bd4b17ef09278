#!/usr/bin/env python
"""Pyramid-at-HD knob sweep: can the coarse-level knobs close the
+7.8 pp accuracy gap accuracy_benchgeo_r5.json measured?

Two outs: close the gap with the knobs that worked at small scale (penalties 0.2/0.4, band radius) or publish the
frontier.  The frontier is published; this script tries the knobs on
the same textured HD scenes and records what each buys, appending a
`pyramid_hd_knobs` section to benchmarks/accuracy_benchgeo_r5.json.

Usage: python tools/pyramid_hd_knobs.py [--scenes 2] [--device cpu]
"""

import argparse
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

VARIANTS = {
    "pyramid2_default": dict(levels=2),
    "pyramid2_p2x": dict(levels=2, penalty1=0.2, penalty2=0.4),
    "pyramid2_r48": dict(levels=2, band_radius=48),
    "pyramid2_p2x_r48": dict(levels=2, penalty1=0.2, penalty2=0.4,
                             band_radius=48),
    "pyramid1_default": dict(levels=1),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", default=str(REPO / "benchmarks"
                                         / "accuracy_benchgeo_r5.json"))
    args = ap.parse_args()

    import jax
    if args.device:
        jax.config.update("jax_platforms", args.device)

    from stereomatch_tpu.io.synthetic import stereo_pair_occluded
    from stereomatch_tpu.pyramid import PyramidPipeline

    h, w, d = 1024, 1280, 256
    scenes = [stereo_pair_occluded(h, w, d, seed=100 + i,
                                   texture="textured")
              for i in range(args.scenes)]

    results = {}
    for name, kw in VARIANTS.items():
        pipe = PyramidPipeline(d, **kw)
        bads = []
        for left, right, gt, occ in scenes:
            disp = np.asarray(pipe.estimate(left, right), np.float32)
            # Match stm-eval's convention: occluded pixels are unknown
            # (no right-view evidence), excluded from the metric.
            known = (gt > 0) & ~occ
            bads.append(float(np.mean(np.abs(disp - gt)[known] > 2.0)))
        results[name] = round(100 * sum(bads) / len(bads), 3)
        print(f"{name}: {results[name]}% bad-pixel", flush=True)

    out = pathlib.Path(args.out)
    payload = json.loads(out.read_text()) if out.exists() else {}
    payload["pyramid_hd_knobs"] = {
        "geometry": f"{h}x{w} D={d}, textured scenes x{args.scenes}",
        "bad_pixel_pct": results,
    }
    out.write_text(json.dumps(payload, indent=1))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
