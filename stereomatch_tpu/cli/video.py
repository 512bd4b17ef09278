#!/usr/bin/env python
"""CLI for estimating disparity from stereo videos / cameras / frame dirs.

Equivalent of the reference's ``stm-video``
(stereomatch/cli_video.py:49-126): capture -> (rectify) -> estimate ->
colormap display, with the same q/h/i/w/e/r key bindings when a display is
available.  Adds an ``imgdir`` input mode (image-sequence replay, cv2-free)
and ``--headless`` for environments without a display, where frames are
written to ``--output-dir`` instead.
"""

import argparse
import pickle
import sys


def _print_instructions() -> None:
    print("""Keys:
                  q/Q: Quit the execution.
                  h/H: Show this help message.
                  i/I: Show the current depthmap with matplotlib.
                  w/W: Toggle the rectified view.
                  e/E: Toggle the rgb view.
                  r/R: Pause/resume.
    """)


def build_parser() -> argparse.ArgumentParser:
    from ..cli_common import (AGGREGATION_METHODS, COST_METHODS,
                              DISPARITY_METHODS)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input_mode",
                        choices=["dev", "file", "imgdir", "y4m"],
                        metavar="input-mode",
                        help="Camera `dev`ice, video `file`, `imgdir` of "
                             "side-by-side frames, or `y4m` stream "
                             "(native decode, no OpenCV needed).")
    parser.add_argument("input", type=str,
                        help="Device index, video path, or frame directory.")
    parser.add_argument("max_disparity", metavar="max-disparity", type=int,
                        help="Maximum disparity")
    parser.add_argument("-cal", "--calib", help="Calibration pickle.")
    parser.add_argument("-cm", "--cost-method", choices=COST_METHODS.keys(),
                        default="ssd")
    parser.add_argument("-am", "--aggregation-method",
                        choices=AGGREGATION_METHODS.keys(), default=None)
    parser.add_argument("-dm", "--disparity-method",
                        choices=DISPARITY_METHODS.keys(), default="wta")
    parser.add_argument("--device", default=None,
                        help="JAX platform (gpu/cpu); default = best available")
    parser.add_argument("--headless", action="store_true",
                        help="No display: write colorized frames to "
                             "--output-dir and exit at end of stream.")
    parser.add_argument("--output-dir", default="depthmaps",
                        help="Headless output directory.")
    parser.add_argument("--max-frames", type=int, default=None,
                        help="Stop after this many frames.")
    parser.add_argument("--batch", type=int, default=None, metavar="N",
                        help="Batched steady state: estimate N frames per "
                             "jitted step through the StreamingEstimator "
                             "(keeps one batch in flight).")
    parser.add_argument("--depth", type=int, default=2, metavar="K",
                        help="With --batch: batches kept in flight before "
                             "a blocking fetch (2 = overlap one batch's "
                             "compute with the next batch's decode).")
    parser.add_argument("--fetch-workers", type=int, default=4,
                        metavar="N",
                        help="Result-fetch threads (effective concurrency "
                             "min(N, --depth)); raise --depth together "
                             "with N.")
    parser.add_argument("--mesh", action="store_true",
                        help="Run frames through the sharded mesh pipeline: "
                             "frames split over the mesh batch axis, "
                             "image rows over the tile axis. "
                             "With --temporal: row-shards the stateful "
                             "tracker on a tile-only mesh instead.")
    parser.add_argument("--sgm-mode", choices=("exact", "overlap"),
                        default="exact",
                        help="Mesh-mode SGM scan splitting strategy.")
    parser.add_argument("--overlap", type=int, default=64,
                        help="Warm-up rows for --sgm-mode overlap.")
    parser.add_argument("--p1", type=float, default=0.1,
                        help="SGM penalty for +-1 disparity changes.")
    parser.add_argument("--cvf-radius", type=int, default=8,
                        help="-am cvf: box window half-size.")
    parser.add_argument("--cvf-eps", type=float, default=1e-4,
                        help="-am cvf: edge-stop regularizer.")
    parser.add_argument("--p2", type=float, default=0.2,
                        help="SGM base penalty for larger jumps.")
    parser.add_argument("--census-window", type=int, default=5,
                        help="-cm census: code window (odd; >5 packs "
                             "several int32 words).")
    parser.add_argument("--backend", choices=("auto", "cuda", "xla"),
                        default="auto",
                        help="SGM implementation: the Hopper CUDA kernel, the XLA "
                             "scans, or auto (the kernel on a Hopper GPU).")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32",
                        help="Cost-volume storage dtype (per-frame path).")
    parser.add_argument("--refine", action="store_true",
                        help="3x3 median + parabolic sub-pixel refinement "
                             "on each depthmap (composes with --batch and "
                             "--mesh).")
    parser.add_argument("--lr-check", action="store_true",
                        help="Left-right consistency check with background "
                             "occlusion fill on each frame.")
    parser.add_argument("--lr-mode", choices=("mirror", "volume"),
                        default="volume",
                        help="Right disparity for --lr-check: 'volume' "
                             "re-indexes the aggregated volume (the SGBM "
                             "trick, ~free); 'mirror' runs the pipeline "
                             "twice per frame (exact right matching).")
    parser.add_argument("--wmf", action="store_true",
                        help="Guide-weighted median filter on each frame "
                             "(edge-preserving; weighted by left-image "
                             "affinity).")
    parser.add_argument("--wmf-sigma", type=float, default=10.0,
                        help="WMF affinity bandwidth in guide gray levels "
                             "(8-bit scale).")
    parser.add_argument("--fgs", type=float, default=None, metavar="LAM",
                        help="Fast-global-smoother (WLS) post-filter on "
                             "each frame; with --lr-check the consistency "
                             "mask weights the data term (occlusion "
                             "inpainting).")
    parser.add_argument("--fgs-sigma", type=float, default=8.0,
                        help="FGS edge-stop bandwidth in guide gray "
                             "levels (8-bit scale).")
    parser.add_argument("--speckle", action="store_true",
                        help="Suppress speckles (small isolated disparity "
                             "blobs) on each depthmap by windowed-support "
                             "filtering; composes with every mode.")
    parser.add_argument("--speckle-fill", choices=("zero", "background"),
                        default="zero",
                        help="Replacement for speckle pixels: 0 (unknown) "
                             "or the scanline background disparity.")
    parser.add_argument("--pyramid", type=int, default=0, metavar="LEVELS",
                        help="Coarse-to-fine census pyramid (~8x less "
                             "volume work per level; overrides -cm/-am/-dm; "
                             "see stm-image).  Composes with --batch "
                             "(lax.map steady state) and --mesh (row-"
                             "sharded pyramid; frame sides must divide by "
                             "2**LEVELS).")
    parser.add_argument("--band-radius", type=int, default=None,
                        metavar="R",
                        help="Per-pixel band half-width (default 4 for "
                             "--pyramid levels, 6 for --temporal "
                             "tracking).")
    parser.add_argument("--temporal", action="store_true",
                        help="Track disparity across frames (census "
                             "band search around the previous frame's "
                             "result; keyframes on --keyframe-interval "
                             "cadence and on drift).  Composes with "
                             "--pyramid for the keyframes and with --mesh "
                             "for row sharding.")
    parser.add_argument("--keyframe-interval", type=int, default=16,
                        metavar="N",
                        help="--temporal: force a full-range keyframe "
                             "every N frames (0 = only on drift).")
    parser.add_argument("--drift-threshold", type=float, default=0.06,
                        metavar="F",
                        help="--temporal: keyframe when this fraction of "
                             "tracked pixels has no plausible census "
                             "match in the band.")
    return parser


def _open_capture(args):
    from ..io.capture import (ImageSequenceCapture, StereoCapture,
                              Y4MCapture)
    if args.input_mode == "dev":
        return StereoCapture.from_device(int(args.input))
    if args.input_mode == "file":
        return StereoCapture.from_file(args.input)
    if args.input_mode == "y4m":
        return Y4MCapture(args.input)
    return ImageSequenceCapture.from_directory(args.input)


class _RectifiedCapture:
    """read_next() adapter applying a StereoRectifier to grayscale frames
    (for the batched paths, which consume captures directly)."""

    def __init__(self, capture, rectifier):
        self._capture = capture
        self._rectifier = rectifier

    def read_next(self):
        import numpy as np
        ok, img = self._capture.read_next()
        if not ok:
            return ok, img
        gray = img if not hasattr(img, "to_grayscale") else img.to_grayscale()
        left, right = self._rectifier(np.asarray(gray.left),
                                      np.asarray(gray.right))

        class _Pair:
            pass

        pair = _Pair()
        pair.left = np.asarray(left)
        pair.right = np.asarray(right)
        return True, pair

    def close(self):
        self._capture.close()


def _pick_video_mesh(height: int, scale: int = 1):
    """(batch, tile) mesh for video: up to 4 devices shard image rows (the
    latency axis — must divide the frame height), the rest batch frames
    (the throughput axis; frames are data-parallel, so it carries no
    collectives and maps onto DCN across hosts).

    ``scale`` > 1 (the pyramid's 2**levels) additionally requires each
    tile's height to stay divisible by it, so 2x2 pooling never splits a
    row pair across a tile boundary."""
    import jax

    from ..parallel.mesh import make_hybrid_mesh
    n = len(jax.devices())
    n_tile, t = 1, 2
    while t <= min(n, 4):
        if n % t == 0 and height % (t * scale) == 0:
            n_tile = t
        t *= 2
    return make_hybrid_mesh(n_tile=n_tile)


def _pick_temporal_mesh(height: int, scale: int = 1):
    """Tile-only mesh for --temporal --mesh: the tracker is stateful per
    frame (no frame batching), so every usable device shards image rows.
    ``scale`` = 2**pyramid_levels keeps tile heights pool-divisible."""
    import jax

    from ..parallel.mesh import make_mesh
    n = len(jax.devices())
    n_tile, t = 1, 2
    while t <= min(n, 4):
        if height % (t * max(scale, 1)) == 0:
            n_tile = t
        t *= 2
    return make_mesh(jax.devices()[:n_tile], n_batch=1)


class _FnEstimator:
    """Adapter giving a compiled mesh program the ``estimate`` surface
    TemporalPipeline expects of a keyframe."""

    def __init__(self, fn):
        self._fn = fn

    def estimate(self, left, right):
        return self._fn(left, right)


def _peek_first_frame(capture, pyramid_levels: int):
    """Read one frame to size a mesh; returns (height, capture', error).

    ``capture'`` re-yields the consumed frame (_ReplayFirst).  ``error``
    is a printable message when the stream is empty or the frame sides
    don't divide by 2**pyramid_levels (the sharded pyramid cannot
    edge-pad inside shard_map: padding would change the per-tile row
    count mid-program).
    """
    import numpy as np

    ok, first = capture.read_next()
    if not ok:
        return None, capture, "empty stream"
    gray = (first if not hasattr(first, "to_grayscale")
            else first.to_grayscale())
    height, width = np.asarray(gray.left).shape
    scale = 2 ** pyramid_levels
    if pyramid_levels and (height % scale or width % scale):
        return None, capture, (
            f"--mesh --pyramid {pyramid_levels} needs frame sides "
            f"divisible by {scale}; got {height}x{width}.")
    return height, _ReplayFirst(capture, first), None


def _run_batched(args, capture, rectifier, headless, out_dir) -> int:
    """--batch / --mesh consumption: StreamingEstimator over the capture,
    single-chip lax.map batching or the sharded mesh program."""
    import numpy as np

    from ..stream import StreamingEstimator
    from ..utils.viz import colorize_disparity

    if rectifier is not None:
        capture = _RectifiedCapture(capture, rectifier)

    import jax.numpy as jnp

    from ..cli_common import STREAM_REDUCERS
    reducer = STREAM_REDUCERS[args.disparity_method]
    common = dict(cost=args.cost_method, aggregation=args.aggregation_method,
                  reducer=reducer, penalty1=args.p1, penalty2=args.p2,
                  census_window=args.census_window,
                  cvf_radius=args.cvf_radius, cvf_eps=args.cvf_eps,
                  backend=args.backend, cost_dtype=jnp.dtype(args.dtype),
                  pyramid_levels=args.pyramid,
                  band_radius=(args.band_radius if args.band_radius is not None
                               else 24),
                  median=args.refine, subpixel=args.refine,
                  lr_check=args.lr_check, lr_mode=args.lr_mode,
                  weighted_median=args.wmf, wmf_sigma=args.wmf_sigma,
                  fgs_lambda=args.fgs, fgs_sigma=args.fgs_sigma,
                  speckle=args.speckle, speckle_fill=args.speckle_fill)
    if args.mesh:
        height, capture, err = _peek_first_frame(capture, args.pyramid)
        if err:
            print(err, file=sys.stderr)
            return 2 if "divisible" in err else 1
        mesh = _pick_video_mesh(height, scale=2 ** args.pyramid)
        estimator = StreamingEstimator(args.max_disparity, mesh=mesh,
                                       batch=args.batch or 0,
                                       depth=args.depth,
                                       fetch_workers=args.fetch_workers,
                                       sgm_mode=args.sgm_mode,
                                       overlap=args.overlap, **common)
    else:
        estimator = StreamingEstimator(args.max_disparity,
                                       batch=args.batch,
                                       depth=args.depth,
                                       fetch_workers=args.fetch_workers,
                                       **common)

    do_quit = False
    frame_idx = 0
    for _, disp in estimator.run(capture, max_frames=args.max_frames):
        frame_idx += 1
        rgb = colorize_disparity(disp, args.max_disparity)
        if headless:
            from PIL import Image
            Image.fromarray(rgb).save(out_dir / f"depth_{frame_idx:06d}.png")
            continue
        import cv2
        cv2.imshow("depthmap", rgb[:, :, ::-1])
        chr_key = chr(cv2.waitKey(1) & 0xFF).lower()
        if chr_key == "q":
            do_quit = True
            break
        if chr_key == "h":
            _print_instructions()
        elif chr_key == "i":
            import matplotlib.pyplot as plt
            plt.imshow(disp)
            plt.show()

    capture.close()
    if headless:
        s = estimator.stats
        print(f"Wrote {frame_idx} depthmaps to {out_dir} "
              f"({s.fps:.1f} fps over {s.batches} batches)")
    elif not do_quit:
        import cv2
        cv2.destroyAllWindows()
    return 0


class _ReplayFirst:
    """Capture wrapper re-yielding an already-read first frame (the mesh
    path peeks at it to size the tile axis)."""

    def __init__(self, capture, first):
        self._capture = capture
        self._first = first

    def read_next(self):
        if self._first is not None:
            first, self._first = self._first, None
            return True, first
        return self._capture.read_next()

    def close(self):
        self._capture.close()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..cli_common import setup_runtime
    setup_runtime(args.device)

    import numpy as np

    from ..cli_common import create_pipeline
    from ..io.calibration import StereoRectifier
    from ..utils.viz import colorize_disparity

    # Temporal is stateful frame-to-frame, so it cannot batch frames —
    # but it CAN shard each frame's rows: --temporal --mesh runs the
    # tracker on a tile-only mesh instead of the batched estimator path.
    batched = (args.batch is not None or args.mesh) and not args.temporal
    pipeline = None
    if args.wmf and args.pyramid > 0:
        print("--wmf is incompatible with --pyramid (the band stage has no "
              "integer disparity/bin range to median over).",
              file=sys.stderr)
        return 2
    if args.fgs is not None and (args.pyramid > 0 or args.temporal):
        print("--fgs is incompatible with --pyramid/--temporal (no flat "
              "post-processing stage there; post-filter offline instead).",
              file=sys.stderr)
        return 2
    if args.lr_check and (args.pyramid > 0 or args.temporal):
        print("--lr-check is incompatible with --pyramid/--temporal (no "
              "full cost volume to re-index; post-filter offline instead).",
              file=sys.stderr)
        return 2
    if args.wmf and args.temporal:
        print("--wmf is incompatible with --temporal (stateful per-frame "
              "path; post-filter offline instead).", file=sys.stderr)
        return 2
    if args.temporal and (args.batch is not None or args.refine):
        print("--temporal is a stateful per-frame path; it is incompatible "
              "with --batch/--refine (row-shard each frame with --mesh).",
              file=sys.stderr)
        return 2
    capture = _open_capture(args)
    temporal_mesh = None
    if args.temporal and args.mesh:
        height, capture, err = _peek_first_frame(capture, args.pyramid)
        if err:
            print(err, file=sys.stderr)
            return 2 if "divisible" in err else 1
        temporal_mesh = _pick_temporal_mesh(height, scale=2 ** args.pyramid)
    if args.pyramid > 0:
        band = args.band_radius if args.band_radius is not None else 24
        if temporal_mesh is not None:
            import jax.numpy as jnp

            from ..parallel import make_pyramid_sharded_estimate
            pipeline = _FnEstimator(make_pyramid_sharded_estimate(
                temporal_mesh, max_disparity=args.max_disparity,
                levels=args.pyramid, band_radius=band,
                cost_dtype=jnp.dtype(args.dtype),
                penalty1=args.p1, penalty2=args.p2,
                sgm_mode=args.sgm_mode, overlap=args.overlap,
                backend=args.backend))
        elif not batched:
            import jax.numpy as jnp

            from ..pyramid import PyramidPipeline
            pipeline = PyramidPipeline(
                args.max_disparity, levels=args.pyramid,
                band_radius=band,
                penalty1=args.p1, penalty2=args.p2, backend=args.backend,
                cost_dtype=jnp.bfloat16 if args.dtype == "bfloat16"
                else jnp.float32)
    elif temporal_mesh is not None:
        import jax.numpy as jnp

        from ..cli_common import STREAM_REDUCERS
        from ..parallel import ShardedPipeline
        pipeline = ShardedPipeline(
            temporal_mesh, args.max_disparity, cost=args.cost_method,
            aggregation=args.aggregation_method,
            reducer=STREAM_REDUCERS[args.disparity_method],
            penalty1=args.p1, penalty2=args.p2,
            cvf_radius=args.cvf_radius, cvf_eps=args.cvf_eps,
            sgm_mode=args.sgm_mode,
            overlap=args.overlap, backend=args.backend,
            cost_dtype=jnp.dtype(args.dtype))
    elif not batched:
        pipeline = create_pipeline(args.cost_method, args.disparity_method,
                                   args.aggregation_method,
                                   max_disparity=args.max_disparity,
                                   penalty1=args.p1, penalty2=args.p2,
                                   cvf_radius=args.cvf_radius,
                                   cvf_eps=args.cvf_eps,
                                   census_window=args.census_window,
                                   backend=args.backend,
                                   volume_dtype=args.dtype)
    if args.temporal:
        from ..temporal import TemporalPipeline
        pipeline = TemporalPipeline(
            args.max_disparity, keyframe=pipeline,
            band_radius=(args.band_radius if args.band_radius is not None
                         else 6),
            keyframe_interval=args.keyframe_interval,
            drift_threshold=args.drift_threshold,
            penalty1=args.p1, penalty2=args.p2, backend=args.backend,
            mesh=temporal_mesh)

    rectifier = None
    if args.calib:
        with open(args.calib, "rb") as f:
            rectifier = StereoRectifier.from_state_dict(pickle.load(f))

    headless = args.headless
    if not headless:
        try:
            import cv2  # noqa: F401
        except ImportError:
            print("OpenCV not available; falling back to --headless.")
            headless = True

    out_dir = None
    if headless:
        from pathlib import Path
        out_dir = Path(args.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)

    if batched:
        return _run_batched(args, capture, rectifier, headless, out_dir)

    def estimate_frame(frame0, frame1):
        """One frame through the warm pipeline, honoring the refine /
        post-processing flags (the per-frame analogue of the batched
        path's stream._build_frame_fn configuration)."""
        f0 = np.asarray(frame0, np.float32)
        f1 = np.asarray(frame1, np.float32)
        if args.refine or args.wmf or args.lr_check or args.fgs is not None:
            kwargs = dict(median=args.refine, subpixel=args.refine)
            if args.pyramid == 0:     # volume-based stages only
                # (--lr-check/--wmf/--fgs with --pyramid were rejected
                # at startup; PyramidPipeline.estimate_refined takes
                # subpixel/median only.)
                kwargs.update(
                    lr_check=args.lr_check, lr_mode=args.lr_mode,
                    weighted_median=args.wmf, wmf_sigma=args.wmf_sigma,
                    fgs_lambda=args.fgs, fgs_sigma=args.fgs_sigma)
            out = pipeline.estimate_refined(f0, f1, **kwargs)
        else:
            out = pipeline.estimate(f0, f1)
        if args.speckle:
            from ..ops.refine import filter_speckles
            out = filter_speckles(out, fill=args.speckle_fill)
        return np.asarray(out)

    session = _InteractiveSession(capture, rectifier, estimate_frame,
                                  args.max_disparity, headless, out_dir,
                                  max_frames=args.max_frames)
    return session.run()


class _InteractiveSession:
    """Display loop for the unbatched `stm-video` path.

    Keystroke surface matches the reference tool's declared contract
    (q/h/i/w/e/r — cli_video.py:108-124) but the loop is organized as a
    dispatch table over toggle state: each key maps to a method, view
    windows are tracked in a dict so toggling one off tears down exactly
    its window, and the same object drives the headless PNG-dump mode
    (where the key surface is inert and frames stream to ``out_dir``).
    """

    def __init__(self, capture, rectifier, estimate_frame, max_disparity,
                 headless, out_dir, max_frames=None):
        self.capture = capture
        self.rectifier = rectifier
        self.estimate_frame = estimate_frame
        self.max_disparity = max_disparity
        self.headless = headless
        self.out_dir = out_dir
        self.max_frames = max_frames
        self.paused = False
        self.running = True
        self.views = {"rgb": False, "rectified": False}
        self.frames_done = 0
        self._last = None                  # (joined, frame0, frame1)
        self._depth = None

    # -- key surface ----------------------------------------------------

    def _key_quit(self):
        self.running = False

    def _key_help(self):
        _print_instructions()

    def _key_inspect(self):
        import matplotlib.pyplot as plt
        plt.imshow(self._depth)
        plt.show()

    def _key_toggle_rgb(self):
        self._toggle_view("rgb")

    def _key_toggle_rectified(self):
        self._toggle_view("rectified")

    def _key_pause(self):
        self.paused = not self.paused

    KEYMAP = {"q": _key_quit, "h": _key_help, "i": _key_inspect,
              "w": _key_toggle_rgb, "e": _key_toggle_rectified,
              "r": _key_pause}

    def _toggle_view(self, name):
        import cv2
        self.views[name] = not self.views[name]
        if not self.views[name]:
            cv2.destroyWindow(name)

    # -- frame flow -----------------------------------------------------

    def _next_pair(self):
        """Capture (or re-serve, when paused) one rectified gray pair."""
        if self.paused and self._last is not None:
            return self._last
        ok, cap = self.capture.read_next()
        if not ok:
            return None
        frame0, frame1, _ = cap.to_grayscale()
        if self.rectifier is not None:
            frame0, frame1 = (np.asarray(x) for x in
                              self.rectifier(frame0, frame1))
        self._last = (cap.joined, frame0, frame1)
        return self._last

    def _present(self, joined, frame0, frame1, rgb_depth):
        import cv2
        if self.views["rgb"]:
            cv2.imshow("rgb", joined)
        if self.views["rectified"]:
            cv2.imshow("rectified", np.hstack([frame0, frame1]))
        cv2.imshow("depthmap", rgb_depth[:, :, ::-1])      # RGB -> BGR
        key = chr(cv2.waitKey(1) & 0xFF).lower()
        handler = self.KEYMAP.get(key)
        if handler is not None:
            handler(self)

    def run(self) -> int:
        from ..utils.viz import colorize_disparity
        if not self.headless:
            _print_instructions()
        while self.running:
            if (self.max_frames is not None
                    and self.frames_done >= self.max_frames):
                break
            pair = self._next_pair()
            if pair is None:
                break
            joined, frame0, frame1 = pair
            self._depth = self.estimate_frame(frame0, frame1)
            rgb_depth = colorize_disparity(self._depth, self.max_disparity)
            self.frames_done += 1
            if self.headless:
                from PIL import Image
                Image.fromarray(rgb_depth).save(
                    self.out_dir / f"depth_{self.frames_done:06d}.png")
            else:
                self._present(joined, frame0, frame1, rgb_depth)
        self.capture.close()
        if self.headless:
            print(f"Wrote {self.frames_done} depthmaps to {self.out_dir}")
        else:
            import cv2
            cv2.destroyAllWindows()
        return 0


if __name__ == "__main__":
    sys.exit(main())
