#!/usr/bin/env python
"""CLI for estimating disparity from a stereo image pair.

Equivalent of the reference's ``stm-image``
(stereomatch/cli_image.py:34-100).  The ``-c/--cuda-on`` flag becomes
``--device`` (JAX picks the GPU automatically; ``--device cpu`` forces the
host backend).
"""

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    from ..cli_common import (AGGREGATION_METHODS, COST_METHODS,
                              DISPARITY_METHODS)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("left_image", metavar="left-image", help="Left image")
    parser.add_argument("right_image", metavar="right-image",
                        help="Right image")
    parser.add_argument("max_disparity", metavar="max-disparity", type=int,
                        help="Maximum disparity for stereo matching.")
    parser.add_argument("output_depthmap", metavar="output-depthmap",
                        help="Output file for the depth map.")
    parser.add_argument("-cm", "--cost-method", choices=COST_METHODS.keys(),
                        default="ssd", help="Cost function.")
    parser.add_argument("-am", "--aggregation-method",
                        choices=AGGREGATION_METHODS.keys(), default=None,
                        help="Aggregation method.")
    parser.add_argument("-dm", "--disparity-method",
                        choices=DISPARITY_METHODS.keys(), default="wta",
                        help="Disparity reduce method.")
    parser.add_argument("--device", default=None,
                        help="JAX platform to run on (e.g. gpu, cpu). "
                             "Defaults to the best available backend.")
    parser.add_argument("-sd", "--show-depthmap", action="store_true",
                        help="Show the depthmap interactively.")
    parser.add_argument("-fig", "--figure", action="store_true",
                        help="Render inputs alongside the depthmap.")
    parser.add_argument("--p1", type=float, default=0.1,
                        help="SGM penalty for +-1 disparity changes.")
    parser.add_argument("--p2", type=float, default=0.2,
                        help="SGM base penalty for larger jumps "
                             "(adaptively scaled by image gradient).")
    parser.add_argument("--cvf-radius", type=int, default=8,
                        help="-am cvf: box window half-size (use smaller "
                             "radii on small images).")
    parser.add_argument("--cvf-eps", type=float, default=1e-4,
                        help="-am cvf: edge-stop regularizer in "
                             "intensity^2 units; larger smooths across "
                             "weaker image edges.")
    parser.add_argument("--cvf-subsample", type=int, default=1,
                        help="-am cvf: > 1 = Fast Guided Filter "
                             "(statistics on an s x-downsampled grid; "
                             "approximate, box-filter work / s^2).")
    parser.add_argument("--census-window", type=int, default=5,
                        help="-cm census: code window (odd; >5 packs "
                             "several int32 words, e.g. 7 or 9 for the "
                             "larger production census windows).")
    parser.add_argument("--backend", choices=("auto", "cuda", "xla"),
                        default="auto",
                        help="SGM implementation: the Hopper CUDA kernel, the XLA "
                             "scans, or auto (the kernel on a Hopper GPU).")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32",
                        help="Cost-volume storage dtype (bfloat16 halves "
                             "HBM traffic; recurrences stay float32).")
    parser.add_argument("--pyramid", type=int, default=0, metavar="LEVELS",
                        help="Coarse-to-fine mode: run census+SGM at "
                             "1/2**LEVELS resolution and disparity range, "
                             "then refine a narrow per-pixel band up to "
                             "full resolution (~8x less volume work per "
                             "level; overrides -cm/-am/-dm).")
    parser.add_argument("--band-radius", type=int, default=24, metavar="R",
                        help="Half-width of the per-pixel refinement band "
                             "in --pyramid mode.")
    parser.add_argument("--refine", action="store_true",
                        help="Post-process: 3x3 median + parabolic "
                             "sub-pixel interpolation.")
    parser.add_argument("--lr-check", action="store_true",
                        help="Left-right consistency check with background "
                             "occlusion fill.")
    parser.add_argument("--lr-mode", choices=("mirror", "volume"),
                        default="mirror",
                        help="Right disparity for --lr-check: 'mirror' "
                             "re-runs the pipeline on mirrored images "
                             "(exact, 2x cost); 'volume' re-indexes the "
                             "left aggregated volume (the SGBM trick, "
                             "~free, approximate under aggregation).")
    parser.add_argument("--wmf", action="store_true",
                        help="Guide-weighted median filter (edge-"
                             "preserving smoothing weighted by left-image "
                             "affinity; runs before --refine's median/"
                             "sub-pixel).")
    parser.add_argument("--wmf-sigma", type=float, default=10.0,
                        help="Affinity bandwidth in guide gray levels "
                             "(8-bit scale).")
    parser.add_argument("--fgs", type=float, default=None, metavar="LAM",
                        help="Fast-global-smoother (WLS) post-filter with "
                             "total smoothness weight LAM (e.g. 128; the "
                             "OpenCV DisparityWLSFilter solver). With "
                             "--lr-check the consistency mask weights the "
                             "data term, inpainting occlusions.")
    parser.add_argument("--fgs-sigma", type=float, default=8.0,
                        help="FGS edge-stop bandwidth in guide gray "
                             "levels (8-bit scale).")
    parser.add_argument("--speckle", action="store_true",
                        help="Suppress speckles (small isolated disparity "
                             "blobs) by windowed-support filtering of the "
                             "final map; composes with every mode.")
    parser.add_argument("--speckle-fill", choices=("zero", "background"),
                        default="zero",
                        help="Replacement for speckle pixels: 0 (unknown, "
                             "the Middlebury convention) or the nearest "
                             "background disparity along the scanline.")
    parser.add_argument("--min-confidence", type=float, default=None,
                        metavar="T",
                        help="Mark pixels with PKRN confidence below T as "
                             "unknown (disparity 0, the Middlebury "
                             "convention; composes with --depth/"
                             "--point-cloud validity).")
    parser.add_argument("--confidence", metavar="PATH", default=None,
                        help="Also write the PKRN matching-confidence map "
                             "(grayscale PNG; white = unambiguous match).")
    parser.add_argument("--calib", metavar="PATH", default=None,
                        help="Middlebury calib.txt (cam0/baseline/doffs) "
                             "enabling metric output (--depth, "
                             "--point-cloud).")
    parser.add_argument("--depth", metavar="PATH", default=None,
                        help="Also write metric depth as a PFM file "
                             "(requires --calib).")
    parser.add_argument("--point-cloud", metavar="PATH", default=None,
                        help="Also write a colored 3-D point cloud as "
                             "binary PLY (requires --calib).")
    parser.add_argument("--max-depth", type=float, default=None,
                        help="Far-plane cut for --point-cloud (drops "
                             "near-zero-disparity blow-ups).")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..cli_common import setup_runtime
    setup_runtime(args.device)

    import numpy as np
    from PIL import Image

    from ..cli_common import create_pipeline

    if args.pyramid > 0:
        # --refine IS supported: the final band scan carries the
        # winner's neighbour costs for in-scan parabolic sub-pixel.
        incompatible = [flag for flag, on in [
            ("--lr-check", args.lr_check),
            ("--wmf", args.wmf),
            ("--fgs", args.fgs is not None),
            ("--min-confidence", args.min_confidence is not None),
            ("--confidence", args.confidence is not None)] if on]
        if incompatible:
            print(f"--pyramid is incompatible with {' '.join(incompatible)} "
                  "(the band stage has no full cost volume to post-process).",
                  file=sys.stderr)
            return 2
        import jax.numpy as jnp
        from ..pyramid import PyramidPipeline
        pipeline = PyramidPipeline(
            args.max_disparity, levels=args.pyramid,
            band_radius=args.band_radius,
            penalty1=args.p1, penalty2=args.p2, backend=args.backend,
            cost_dtype=jnp.bfloat16 if args.dtype == "bfloat16"
            else jnp.float32)
    else:
        pipeline = create_pipeline(args.cost_method, args.disparity_method,
                                   args.aggregation_method,
                                   max_disparity=args.max_disparity,
                                   penalty1=args.p1, penalty2=args.p2,
                                   cvf_radius=args.cvf_radius,
                                   cvf_eps=args.cvf_eps,
                                   cvf_subsample=args.cvf_subsample,
                                   census_window=args.census_window,
                                   backend=args.backend,
                                   volume_dtype=args.dtype)

    left_rgb = Image.open(args.left_image)
    right_rgb = Image.open(args.right_image)
    left = np.array(left_rgb.convert("L"), np.float32)
    right = np.array(right_rgb.convert("L"), np.float32)

    if (args.refine or args.lr_check or args.wmf or args.fgs is not None
            or args.min_confidence is not None):
        kwargs = dict(subpixel=args.refine, median=args.refine)
        if args.pyramid == 0:       # volume-based post-processing only
            kwargs.update(lr_check=args.lr_check, lr_mode=args.lr_mode,
                          weighted_median=args.wmf,
                          wmf_sigma=args.wmf_sigma,
                          fgs_lambda=args.fgs, fgs_sigma=args.fgs_sigma,
                          min_confidence=args.min_confidence)
        disparity = np.asarray(pipeline.estimate_refined(
            left, right, **kwargs))
    else:
        disparity = np.asarray(pipeline.estimate(left, right))
    if args.speckle:
        from ..ops.refine import filter_speckles
        disparity = np.asarray(filter_speckles(disparity,
                                               fill=args.speckle_fill))
    canvas = render_panels(disparity,
                           inputs=((left_rgb, right_rgb) if args.figure
                                   else None))
    Image.fromarray(canvas).save(args.output_depthmap)

    if args.confidence:
        conf = np.asarray(pipeline.last_confidence())
        Image.fromarray((conf * 255).astype(np.uint8)).save(args.confidence)

    if args.depth or args.point_cloud:
        if not args.calib:
            print("--depth/--point-cloud require --calib.", file=sys.stderr)
            return 2
        from ..reconstruction import (CameraIntrinsics, depth_from_disparity,
                                      reproject_disparity, write_ply)
        intr = CameraIntrinsics.from_middlebury_calib(args.calib)
        if args.depth:
            from ..io.data import write_pfm
            write_pfm(args.depth,
                      np.asarray(depth_from_disparity(disparity, intr)))
        if args.point_cloud:
            points = np.asarray(reproject_disparity(disparity, intr))
            n = write_ply(args.point_cloud, points,
                          colors=np.asarray(left_rgb.convert("RGB")),
                          max_depth=args.max_depth)
            print(f"{args.point_cloud}: {n} points", file=sys.stderr)

    if args.show_depthmap:
        import matplotlib.pyplot as plt
        plt.imshow(canvas)
        plt.axis("off")
        plt.show()
    return 0


def render_panels(disparity, inputs=None, pad: int = 8):
    """Render the disparity map — optionally beside the input pair — as one
    uint8 RGB canvas (pixel-exact, no plotting-library margins/DPI).

    The disparity map is colormapped over its own range; when
    ``inputs`` is given, the three panels are letterboxed to a common
    height and separated by white gutters.
    """
    import numpy as np
    from ..utils.viz import colorize_disparity

    panels = [colorize_disparity(disparity)]
    if inputs is not None:
        rgb = [np.ascontiguousarray(np.asarray(im.convert("RGB")))
               for im in inputs]
        panels = rgb + panels

    height = max(p.shape[0] for p in panels)
    boxed = []
    for p in panels:
        top = (height - p.shape[0]) // 2
        boxed.append(np.pad(p, ((top, height - p.shape[0] - top),
                                (0, 0), (0, 0)),
                            constant_values=255))
    gutter = np.full((height, pad, 3), 255, np.uint8)
    strip = [boxed[0]]
    for p in boxed[1:]:
        strip += [gutter, p]
    return np.concatenate(strip, axis=1)


if __name__ == "__main__":
    sys.exit(main())
