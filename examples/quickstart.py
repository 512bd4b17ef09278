#!/usr/bin/env python
"""Zero-network quickstart: synthetic scene -> disparity -> depth -> PLY.

Runs everywhere (CPU or GPU) with nothing to download: generates an
occlusion-aware synthetic stereo pair with exact ground truth, runs the
census + 8-path SGM + WTA pipeline with post-processing, scores it
against the ground truth, and reprojects the result to a colored 3-D
point cloud.

    python examples/quickstart.py [--out-dir out] [--cpu]

Outputs (in --out-dir): left.png, disparity.png (colorized),
disparity.pfm, cloud.ply, and a metrics line on stdout.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out-dir", default="quickstart-out")
    parser.add_argument("--cpu", action="store_true",
                        help="force the CPU backend")
    parser.add_argument("--height", type=int, default=120)
    parser.add_argument("--width", type=int, default=160)
    parser.add_argument("--max-disparity", type=int, default=32)
    args = parser.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    from PIL import Image

    from stereomatch_tpu.cli_common import create_pipeline
    from stereomatch_tpu.io.synthetic import stereo_pair_occluded
    from stereomatch_tpu.reconstruction import (CameraIntrinsics,
                                                reproject_disparity,
                                                write_ply)
    from stereomatch_tpu.utils.viz import colorize_disparity

    out = pathlib.Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    h, w, d = args.height, args.width, args.max_disparity

    # 1. A scene with exact ground truth and true occlusions.
    left, right, gt, occluded = stereo_pair_occluded(h, w, d, seed=7)

    # 2. The pipeline, exactly as `stm-image -cm census` builds it.
    pipe = create_pipeline("census", "wta", "sgm", max_disparity=d)
    disparity = np.asarray(pipe.estimate_refined(left, right))

    # 3. Score where matching is solvable (not occluded, d <= x valid).
    valid = ~occluded
    valid[:, :d] = False
    bad = np.abs(disparity - gt) > 1
    print(f"bad-pixel (>1px, non-occluded): "
          f"{100 * bad[valid].mean():.2f}%  "
          f"rmse: {np.sqrt(((disparity - gt)[valid] ** 2).mean()):.3f}px")

    # 4. Artifacts: images, a float PFM, and a colored point cloud under
    #    a plausible camera (f=0.8*w px, baseline 0.1 m).
    Image.fromarray((left * 255).astype(np.uint8)).save(out / "left.png")
    Image.fromarray(colorize_disparity(disparity, d)).save(
        out / "disparity.png")
    from stereomatch_tpu.io.data import write_pfm
    with open(out / "disparity.pfm", "wb") as f:
        write_pfm(f, disparity.astype(np.float32))

    cam = CameraIntrinsics(focal=0.8 * w, cx=w / 2, cy=h / 2,
                           baseline=0.1, doffs=0.0)
    pts = np.asarray(reproject_disparity(disparity, cam))
    keep = np.asarray(disparity > 0) & valid
    gray = np.repeat((left * 255).astype(np.uint8)[..., None], 3, axis=-1)
    write_ply(out / "cloud.ply", pts[keep], colors=gray[keep])
    print(f"wrote {out}/left.png, disparity.png, disparity.pfm, cloud.ply "
          f"({int(keep.sum())} points)")


if __name__ == "__main__":
    main()
