#!/usr/bin/env python
"""stm-serve: HTTP disparity service over the compiled pipeline.

Production-serving face of the engine (beyond the reference's CLI
surface — its closest analogue is the interactive video loop,
stereomatch/cli_video.py:49-126).  One pipeline is configured and
compiled at startup exactly like ``stm-image`` (same ``-cm/-am/-dm``
registries, penalties, backend, dtype, pyramid mode); requests then ride
the warm XLA executable — no per-request compilation, tracing, or
configuration.

Protocol (stdlib-only on both ends):

* ``POST /estimate`` — body: one side-by-side stereo image (left|right
  halves, any PIL-readable format, or a raw ``.npy`` ``[H, 2W]``
  grayscale array for machine clients; the ``stm-video`` frame
  convention).
  Query parameters: ``format=png16|png|pfm|npy`` (default ``png16``:
  uint16 grayscale disparities; ``png`` = colorized visualization;
  ``npy`` carries the smallest lossless dtype — uint8/uint16 for
  integer disparities, float32 when refined/speckled), ``refine=1``
  for median + sub-pixel, ``speckle=1`` for windowed-support speckle
  suppression (background fill), per request (float outputs round
  under png16).
* ``GET /healthz`` — JSON: status, the serving config, frames served.

Threaded server: decode/encode run concurrently while JAX serializes
device work per process.  With ``--batch 1`` (default) each request is
one jitted call.  ``--batch N`` turns on request micro-batching:
concurrent requests with the same frame
geometry and refine flag are coalesced (waiting at most ``--linger-ms``
for company) into ONE ``lax.map``-batched device program, amortizing
dispatch and running the single-frame program back to back.  Batches
are padded up to the next power of two, so each (geometry, refine,
speckle) key compiles at most log2(N)+1 programs — ``--warmup HxW``
compiles all of them up front.  ``--mesh`` additionally spans every
device: coalesced batches split over the mesh batch axis and image
rows over the tile axis (the ``stm-video --mesh`` sharded program
behind the HTTP face), with the same per-key compile count.
"""

import argparse
import io
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def build_parser() -> argparse.ArgumentParser:
    from ..cli_common import (AGGREGATION_METHODS, COST_METHODS,
                              DISPARITY_METHODS)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("max_disparity", metavar="max-disparity", type=int)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8792)
    parser.add_argument("-cm", "--cost-method", choices=COST_METHODS.keys(),
                        default="census")
    parser.add_argument("-am", "--aggregation-method",
                        choices=AGGREGATION_METHODS.keys(), default="sgm")
    parser.add_argument("-dm", "--disparity-method",
                        choices=DISPARITY_METHODS.keys(), default="wta")
    parser.add_argument("--p1", type=float, default=0.1)
    parser.add_argument("--p2", type=float, default=0.2)
    parser.add_argument("--lr-check", action="store_true",
                        help="Left-right consistency check + background "
                             "occlusion fill on every response "
                             "(server-level flag).")
    parser.add_argument("--lr-mode", choices=("mirror", "volume"),
                        default="volume",
                        help="Right disparity for --lr-check: 'volume' "
                             "re-indexes the aggregated volume (~free); "
                             "'mirror' doubles the device work.")
    parser.add_argument("--fgs", type=float, default=None, metavar="LAM",
                        help="Fast-global-smoother (WLS) post-filter on "
                             "every response (server-level flag; with "
                             "--lr-check the consistency mask weights "
                             "the data term).")
    parser.add_argument("--fgs-sigma", type=float, default=8.0,
                        help="FGS edge-stop bandwidth in guide gray "
                             "levels (8-bit scale).")
    parser.add_argument("--wmf", action="store_true",
                        help="Apply the guide-weighted median to every "
                             "response (server-level: one program config; "
                             "per-request toggles stay refine/speckle).")
    parser.add_argument("--wmf-sigma", type=float, default=10.0,
                        help="WMF affinity bandwidth in guide gray levels "
                             "(8-bit scale).")
    parser.add_argument("--census-window", type=int, default=5,
                        help="-cm census: code window (odd; >5 packs "
                             "several int32 words, e.g. 7 or 9 for the "
                             "larger production census windows).")
    parser.add_argument("--cvf-radius", type=int, default=8,
                        help="-am cvf: box window half-size.")
    parser.add_argument("--cvf-eps", type=float, default=1e-4,
                        help="-am cvf: edge-stop regularizer.")
    parser.add_argument("--backend", choices=("auto", "cuda", "xla"),
                        default="auto")
    parser.add_argument("--dtype", choices=("float32", "bfloat16", "auto"),
                        default="float32",
                        help="Cost-volume dtype; 'auto' is float32 (bf16 "
                             "is the lower-precision opt-in).")
    parser.add_argument("--pyramid", type=int, default=0, metavar="LEVELS",
                        help="Serve the coarse-to-fine pyramid instead of "
                             "the flat pipeline (overrides -cm/-am/-dm).")
    parser.add_argument("--device", default=None,
                        help="JAX platform (gpu/cpu); default = best "
                             "available.")
    parser.add_argument("--warmup", default=None, metavar="HxW",
                        help="Compile for this frame geometry at startup "
                             "so the first request doesn't pay the "
                             "compile (e.g. 375x450).")
    parser.add_argument("--batch", type=int, default=1, metavar="N",
                        help="Coalesce up to N concurrent requests into "
                             "one batched device call (1 = no batching).")
    parser.add_argument("--dispatch-workers", type=int, default=None,
                        metavar="N",
                        help="Worker threads that each carry one batch "
                             "through its FULL device round trip "
                             "(upload + dispatch + result fetch) "
                             "concurrently (default 16, matching the "
                             "HTTP handler concurrency; in-flight "
                             "device memory is bounded in FRAMES at "
                             "max(N, 2*batch)).  Each worker holds at "
                             "most one in-flight batch, so N also "
                             "bounds device-resident batches.")
    parser.add_argument("--fetch-workers", type=int, default=None,
                        help="Deprecated alias for --dispatch-workers.")
    parser.add_argument("--no-adaptive-batch", dest="adaptive_batch",
                        action="store_false", default=True,
                        help="Disable the automatic micro-batch degrade/"
                             "restore (by default the worker halves its "
                             "effective batch cap whenever rolling queue "
                             "time per frame exceeds 2x device time per "
                             "frame, and restores it as the queue "
                             "drains).")
    parser.add_argument("--linger-ms", type=float, default=5.0,
                        help="With --batch > 1: how long a request waits "
                             "for companions before running short.")
    parser.add_argument("--mesh", action="store_true",
                        help="Serve over all devices: batched frames "
                             "split across the mesh batch axis and image "
                             "rows across the tile axis (the stm-video "
                             "--mesh program behind the HTTP face; "
                             "implies request batching).")
    parser.add_argument("--pipeline-depth", type=int, default=2,
                        metavar="N",
                        help="1 = fully synchronous batcher (gather, "
                             "dispatch, fetch one batch at a time); > 1 "
                             "(default) = concurrent batches via the "
                             "--dispatch-workers pool.  Identical "
                             "results either way.")
    parser.add_argument("--request-timeout-s", type=float, default=600.0,
                        help="With batching: how long a request waits on "
                             "the device worker before failing with 500 "
                             "(a hung device call must not pile up handler "
                             "threads forever).")
    return parser


def _build_pipeline(args):
    if args.pyramid > 0:
        import jax.numpy as jnp

        from ..pyramid import PyramidPipeline
        return PyramidPipeline(
            args.max_disparity, levels=args.pyramid,
            penalty1=args.p1, penalty2=args.p2, backend=args.backend,
            cost_dtype=jnp.bfloat16 if args.dtype == "bfloat16"
            else jnp.float32)
    from ..cli_common import create_pipeline
    return create_pipeline(args.cost_method, args.disparity_method,
                           args.aggregation_method,
                           max_disparity=args.max_disparity,
                           penalty1=args.p1, penalty2=args.p2,
                           cvf_radius=args.cvf_radius, cvf_eps=args.cvf_eps,
                           census_window=args.census_window,
                           backend=args.backend, volume_dtype=args.dtype)


def _encode(disparity, fmt: str, max_disparity: int):
    """disparity [H, W] -> (bytes, content_type)."""
    import numpy as np

    if fmt == "npy":
        buf = io.BytesIO()
        np.save(buf, np.asarray(disparity))
        return buf.getvalue(), "application/octet-stream"
    if fmt == "pfm":
        from ..io.data import write_pfm
        buf = io.BytesIO()
        write_pfm(buf, np.asarray(disparity, np.float32))
        return buf.getvalue(), "application/octet-stream"
    from PIL import Image
    buf = io.BytesIO()
    if fmt == "png":
        from ..utils.viz import colorize_disparity
        Image.fromarray(colorize_disparity(np.asarray(disparity),
                                           max_disparity)).save(buf, "PNG")
        return buf.getvalue(), "image/png"
    if fmt == "png16":
        d16 = np.clip(np.round(np.asarray(disparity, np.float64)),
                      0, 65535).astype(np.uint16)
        # Pillow infers I;16 from the uint16 dtype; passing mode= is
        # deprecated (removal scheduled for Pillow 13).
        Image.fromarray(d16).save(buf, "PNG")
        return buf.getvalue(), "image/png"
    raise ValueError(f"unknown format {fmt!r}")


def _narrow_for_fetch(out, max_disparity: int):
    """Device-side cast before the host fetch.

    Integer disparities are < max_disparity, so uint8 (D <= 256) or
    uint16 is lossless and cuts the device->host fetch bytes 4x / 2x.
    Float (refined)
    outputs pass through: float32 is part of the response contract.
    """
    import jax.numpy as jnp
    if out.dtype == jnp.int32:
        return out.astype(jnp.uint8 if max_disparity <= 256 else jnp.uint16)
    return out


class _Job:
    """One request waiting inside the batcher."""

    __slots__ = ("left", "right", "refine", "speckle", "t0", "done",
                 "result", "error")

    def __init__(self, left, right, refine, speckle):
        self.left, self.right = left, right
        self.refine, self.speckle = refine, speckle
        self.t0 = time.monotonic()
        self.done = threading.Event()
        self.result = None
        self.error = None

    @property
    def key(self):
        # dtype is part of the key: npy requests may carry float frames
        # and must not stack with (and promote) a uint8 batch.
        return (self.left.shape, str(self.left.dtype),
                self.refine, self.speckle)


class _Batcher:
    """Coalesces concurrent requests into batched device calls.

    One daemon worker owns all JAX work: it takes the oldest pending
    request, waits until ``linger`` seconds past that request's arrival
    for more requests with the same (frame geometry, refine, speckle)
    key, stacks them, and runs a single jitted ``lax.map`` program over
    the batch (padded to the next power of two — at most
    log2(max_batch)+1 compilations per key).  Requests with a different
    key park in a local list and lead the next batch, preserving
    arrival order per key; anchoring the linger deadline to arrival
    time means a parked request that already waited out a foreign
    batch runs immediately when it becomes leader.

    The batched frame function is stream._build_frame_fn with
    median=subpixel=refine — the same op sequence ``Pipeline
    .estimate_refined`` (its default flags) applies — and in-graph
    speckle suppression, so batched and unbatched responses are
    identical and a speckled request costs no extra device round trip.

    With ``--pipeline-depth`` > 1 (the default) formed batches hand off
    to a pool of ``--dispatch-workers`` threads, each carrying ONE batch
    through its full device round trip — upload + dispatch + result
    fetch — before taking the next, so N workers overlap N dispatches
    and fetches (a stage funneled through a single thread caps
    small-batch throughput at one call at a time, while the unbatched
    path overlaps across its HTTP handler threads).  Device memory is
    bounded in FRAMES (max(N, 2*batch) in flight): 16 size-1 groups
    cost what 2 size-8 groups cost, so degraded/linger-0 traffic
    overlaps 16-way while full batches keep the two-deep profile; a
    maxsize-1 hand-off queue backpressures the gatherer on top.
    Batches may complete in any order relative to each other — each
    request waits on its own per-job event, so completion order is
    irrelevant to correctness.
    """

    def __init__(self, args):
        self.args = args
        self.max_batch = max(args.batch, 1)
        self.linger = max(args.linger_ms, 0.0) / 1e3
        self.queue = queue.SimpleQueue()
        self._fns = {}
        self.batches = 0
        self.batched_frames = 0
        # Instrumentation (read under _finish's implicit serialization;
        # /healthz reads may race by one batch — fine for stats):
        self.padded_frames = 0           # device frames burned on padding
        self.device_s = 0.0              # dispatch -> host-result seconds
        self.queue_s = 0.0               # request arrival -> dispatch
        # Adaptive micro-batch cap: when rolling queue time per frame
        # dwarfs device time per frame, the configured batch size is
        # hurting latency without buying throughput (lax.map device
        # time is linear in batch size; batching mostly amortizes
        # dispatch).  The worker then halves its effective cap — and
        # restores it when the queue drains.
        self.eff_batch = self.max_batch
        self.adaptive = bool(getattr(args, "adaptive_batch", True))
        self._direct_lock = threading.Lock()   # eff_batch == 1 fast path
        self._direct_pool = None         # lazy: fetch-with-timeout pool
        self._q_ema = None               # rolling queue s/frame
        self._d_ema = None               # rolling device s/frame
        self._adapt_n = 0
        # Counters above are bumped from concurrent dispatch workers and
        # handler threads; += on attributes is not atomic under the GIL.
        self._stats_lock = threading.Lock()
        self._fn_lock = threading.Lock()   # one compile per key
        self.inflight = 0                # batches inside dispatch->fetch
        self.depth = max(getattr(args, "pipeline_depth", 1), 1)
        if self.depth > 1:
            # A dispatch-worker pool: each worker owns a batch end to
            # end — np.stack + fn() dispatch + np.asarray fetch, which
            # release the GIL while the device works — so N workers run
            # N batches concurrently instead of funneling every dispatch
            # through the one batcher thread.  The maxsize-1 hand-off
            # bounds device-resident batches at workers + 1.
            workers = getattr(args, "dispatch_workers", None)
            if workers is None:
                workers = getattr(args, "fetch_workers", None)  # alias
            self.workers = max(1, workers if workers is not None else 16)
            # Device-memory bound in FRAMES, not batches: 16 size-1
            # groups in flight cost what 2 size-8 groups cost, so small
            # (linger-0 / degraded) batches may overlap
            # 16-way — matching the unbatched path's handler-thread
            # concurrency — while large batches stay at the old
            # two-batches-deep profile.
            self.frame_cap = max(self.workers, 2 * self.max_batch)
            self._inflight_frames = 0
            self._cap_cv = threading.Condition()
            self._dispatch_q = queue.Queue(maxsize=1)
            for i in range(self.workers):
                threading.Thread(target=self._dispatch_loop, daemon=True,
                                 name=f"stm-serve-dispatch-{i}").start()
        else:
            self.workers = 0
        threading.Thread(target=self._loop, daemon=True,
                         name="stm-serve-batcher").start()

    def estimate(self, left, right, refine: bool, speckle: bool = False):
        job = _Job(left, right, refine, speckle)
        if self.eff_batch <= 2 and not self.args.mesh:
            # Small-batch fast path: batches of one or two gain nothing
            # from the gather/worker funnel — pairing two frames saves
            # one dispatch where the handler threads already overlap
            # sixteen.  So eff_batch <= 2 serves each request directly
            # in its handler thread: upload outside the lock, dispatch
            # briefly locked, fetch in a pooled future with the
            # request-timeout deadline.  The adaptive EMAs keep
            # updating, so real batching (>= 4) re-engages when
            # configured and the queue pressure clears.  The funnel
            # path's request-timeout contract holds here too: the
            # dispatch lock is acquired with a deadline and the host
            # fetch runs in a pooled future, so a hung fetch surfaces a
            # 500 instead of pinning every handler thread.
            import numpy as np
            t0 = job.t0
            deadline = t0 + self.args.request_timeout_s
            if self._direct_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                with self._stats_lock:
                    if self._direct_pool is None:
                        self._direct_pool = ThreadPoolExecutor(
                            max_workers=32,
                            thread_name_prefix="stm-serve-direct")

            def _run_direct():
                import jax
                fn, _ = self._fn(job)
                # Upload OUTSIDE the dispatch lock, so concurrent
                # requests' host->device transfers overlap instead of
                # serializing behind it — the unbatched server path
                # device_puts before its lock for the same reason.
                left_dev = jax.device_put(job.left[None])
                right_dev = jax.device_put(job.right[None])
                if not self._direct_lock.acquire(
                        timeout=max(deadline - time.monotonic(), 0.0)):
                    raise RuntimeError(
                        f"device work did not complete within "
                        f"{self.args.request_timeout_s:g}s")
                try:
                    now = time.monotonic()
                    with self._stats_lock:
                        self.queue_s += now - t0
                    out = _narrow_for_fetch(fn(left_dev, right_dev),
                                            self.args.max_disparity)
                finally:
                    self._direct_lock.release()
                return now, np.asarray(out)[0]

            # The WHOLE direct round trip runs in a pooled future so a
            # hung compile/upload/fetch surfaces the request timeout
            # instead of pinning the handler thread (the funnel path's
            # contract, kept here).
            fut = self._direct_pool.submit(_run_direct)
            try:
                now, host = fut.result(
                    timeout=max(deadline - time.monotonic(), 0.0))
            except TimeoutError:
                raise RuntimeError(
                    f"device work did not complete within "
                    f"{self.args.request_timeout_s:g}s") from None
            batch_device_s = time.monotonic() - now
            with self._stats_lock:
                self.device_s += batch_device_s
                self.batches += 1
                self.batched_frames += 1
            self._adapt(1, now - t0, batch_device_s)
            return host
        self.queue.put(job)
        if not job.done.wait(timeout=self.args.request_timeout_s):
            # The worker may still complete the job later; this request
            # just stops waiting (a hung device call must not
            # accumulate blocked handler threads).
            raise RuntimeError(
                f"device work did not complete within "
                f"{self.args.request_timeout_s:g}s")
        if job.error is not None:
            raise job.error
        return job.result

    def warmup(self, left, right, refine: bool = False,
               speckle: bool = False):
        """Compile every padded batch size for one (geometry, flags) key
        by running synthetic groups of each power-of-two size directly
        (bypassing the queue; stats are restored after)."""
        batches, frames = self.batches, self.batched_frames
        b = 1
        while b <= self.max_batch:
            group = [_Job(left, right, refine, speckle) for _ in range(b)]
            self._run(group)
            for job in group:
                if job.error is not None:
                    raise job.error
            b *= 2
        self.batches, self.batched_frames = batches, frames
        # Warmup batches carry COMPILE time: letting them seed the
        # adaptive EMAs inflates device-time and deflates queue-time, so
        # the degrade trigger (queue > 2x device) can stay suppressed
        # for the entire measurement window (seen in the r04 pass-6
        # sweep: ratio 3.7 with eff_batch still at the configured size).
        self._q_ema = None
        self._d_ema = None
        self._adapt_n = 0

    # -- worker side ----------------------------------------------------

    def _fn(self, job):
        """(batched fn, batch-size multiple) for one job's key.

        Single-chip fns are shape-polymorphic (jit re-specializes per
        padded batch shape), so they cache under (refine, speckle)
        alone; mesh programs bake the tile split for one geometry and
        cache under the full key."""
        import jax.numpy as jnp

        from ..cli_common import STREAM_REDUCERS
        a = self.args
        refine, speckle = job.refine, job.speckle
        dtype = jnp.bfloat16 if a.dtype == "bfloat16" else jnp.float32
        if a.mesh:
            key = job.key
            if key not in self._fns:
                from ..parallel.mesh import BATCH_AXIS
                from ..stream import StreamingEstimator
                from .video import _pick_video_mesh
                mesh = _pick_video_mesh(job.left.shape[0],
                                        scale=2 ** a.pyramid)
                est = StreamingEstimator(
                    a.max_disparity, batch=self.max_batch,
                    cost=a.cost_method, cost_dtype=dtype,
                    census_window=a.census_window,
                    aggregation=a.aggregation_method,
                    reducer=STREAM_REDUCERS[a.disparity_method],
                    penalty1=a.p1, penalty2=a.p2,
                    cvf_radius=a.cvf_radius, cvf_eps=a.cvf_eps,
                    backend=a.backend,
                    mesh=mesh, pyramid_levels=a.pyramid,
                    median=refine, subpixel=refine,
                    lr_check=a.lr_check, lr_mode=a.lr_mode,
                    weighted_median=a.wmf, wmf_sigma=a.wmf_sigma,
                    fgs_lambda=a.fgs, fgs_sigma=a.fgs_sigma,
                    speckle=speckle, speckle_fill="background")
                self._fns[key] = (est.estimate_batch,
                                  mesh.shape[BATCH_AXIS])
            return self._fns[key]
        if (refine, speckle) not in self._fns:
            import jax
            from jax import lax
            if a.pyramid > 0:
                pyr = _build_pipeline(a)
                pyr_fn = lambda l, r: pyr._estimate(l, r, refine)  # noqa: E731
                if speckle:
                    from ..ops.refine import filter_speckles
                    frame_fn = lambda l, r: filter_speckles.__wrapped__(  # noqa: E731
                        pyr_fn(l, r), fill="background")
                else:
                    frame_fn = pyr_fn
            else:
                from ..stream import _build_frame_fn
                frame_fn = _build_frame_fn(
                    a.max_disparity, a.cost_method, None,
                    a.aggregation_method,
                    STREAM_REDUCERS[a.disparity_method],
                    a.p1, a.p2, a.backend, dtype,
                    cvf_radius=a.cvf_radius, cvf_eps=a.cvf_eps,
                    census_window=a.census_window,
                    median=refine, subpixel=refine,
                    lr_check=a.lr_check, lr_mode=a.lr_mode,
                    weighted_median=a.wmf, wmf_sigma=a.wmf_sigma,
                    fgs_lambda=a.fgs, fgs_sigma=a.fgs_sigma,
                    speckle=speckle, speckle_fill="background")
            # Fetch narrowing is FUSED into the jitted program: one
            # device call per batch instead of a separate narrow
            # dispatch (the mesh path keeps its external narrow in
            # _dispatch).
            def batched(l, r, frame_fn=frame_fn):
                out = lax.map(lambda p: frame_fn(*p),
                              (l.astype(jnp.float32),
                               r.astype(jnp.float32)))
                return _narrow_for_fetch(out, a.max_disparity)

            self._fns[refine, speckle] = (jax.jit(batched), 1)
        return self._fns[refine, speckle]

    @staticmethod
    def _chunk_sizes(n: int, multiple: int, cap: int):
        """Decompose a group of n into power-of-two device batch sizes
        (x the mesh batch multiple), largest first.

        The compiled program sequences frames with ``lax.map``, so device
        time is linear in the PADDED size — padding a 5-request group to
        8 burns 60% extra compute.  Splitting into pow-2 chunks (5 ->
        4 + 1) keeps the compiled-shape count at log2(max_batch)+1 while
        making padding waste zero single-chip (< one mesh multiple on a
        mesh, where the batch axis must be filled exactly)."""
        sizes = []
        rem = n
        while rem > 0:
            if rem < multiple:
                sizes.append(multiple)            # final ragged mesh pad
                break
            b = multiple
            while b * 2 <= min(rem, cap):
                b *= 2
            sizes.append(b)
            rem -= b
        return sizes

    def _dispatch(self, group):
        """Upload + queue the batched program(s); returns device results
        without waiting (XLA computes while the caller moves on)."""
        import jax
        import numpy as np
        now = time.monotonic()
        batch_queue_s = sum(now - j.t0 for j in group)
        with self._stats_lock:
            self.queue_s += batch_queue_s
        with self._fn_lock:       # one compile per key across workers
            fn, multiple = self._fn(group[0])
        outs = []
        i = 0
        for size in self._chunk_sizes(len(group), multiple,
                                      self.max_batch):
            chunk = group[i:i + size]
            i += size
            pad = size - len(chunk)
            with self._stats_lock:
                self.padded_frames += pad
            lefts = [j.left for j in chunk] + [chunk[-1].left] * pad
            rights = [j.right for j in chunk] + [chunk[-1].right] * pad
            # Upload in the request dtype (uint8 frames: 4x fewer bytes
            # to copy), widen to float32 inside the program.  Host
            # arrays go straight into the call.  The narrow
            # is fused inside the single-chip program; for the mesh
            # path (still int32 out) it applies here, and it is a
            # no-op on already-narrow outputs.
            outs.append(_narrow_for_fetch(
                fn(np.stack(lefts), np.stack(rights)),
                self.args.max_disparity))
        return (now, batch_queue_s, outs)

    def _finish(self, group, out):
        """Fetch the batch result and release its waiting requests."""
        import numpy as np
        try:
            if isinstance(out, Exception):
                raise out
            t_disp, batch_queue_s, outs = out
            host = np.concatenate([np.asarray(o) for o in outs])
            batch_device_s = time.monotonic() - t_disp
            with self._stats_lock:
                self.device_s += batch_device_s
            self._adapt(len(group), batch_queue_s, batch_device_s)
            for job, disp in zip(group, host):
                job.result = disp
        except Exception as exc:                  # noqa: BLE001 — fan out
            for job in group:
                job.error = exc
        finally:
            with self._stats_lock:
                self.batches += 1
                self.batched_frames += len(group)
            for job in group:
                job.done.set()

    def _adapt(self, n_frames, batch_queue_s, batch_device_s):
        """Auto-degrade/restore the effective micro-batch cap.

        Rolling per-frame queue vs device time (EMA over batches): queue
        dominating by 2x means requests age in line while the device
        runs long sequential ``lax.map`` programs — halve the cap so
        latency tracks the single-frame device time; queue falling under
        half the device time means the batcher has headroom — restore
        toward the configured ``--batch``.  Hysteresis: adjust at most
        once per 8 completed batches, thresholds 2x apart, so the cap
        cannot flap.  Disable with --no-adaptive-batch.
        """
        if not self.adaptive or self.max_batch <= 1 or n_frames <= 0:
            return
        q = batch_queue_s / n_frames
        d = batch_device_s / n_frames
        alpha = 0.25
        with self._stats_lock:
            self._q_ema = q if self._q_ema is None else \
                (1 - alpha) * self._q_ema + alpha * q
            self._d_ema = d if self._d_ema is None else \
                (1 - alpha) * self._d_ema + alpha * d
            self._adapt_n += 1
            if self._adapt_n < 8:
                return
            self._adapt_n = 0
            if self._q_ema > 2.0 * self._d_ema and self.eff_batch > 1:
                self.eff_batch //= 2
            elif (self._q_ema < 0.5 * self._d_ema
                  and self.eff_batch < self.max_batch):
                # Clamp: a non-power-of-two --batch (e.g. 6) degrades
                # 6 -> 3 -> 1; doubling back up must stop AT the
                # configured cap, not sail past it.
                self.eff_batch = min(self.eff_batch * 2, self.max_batch)

    def _run(self, group):
        """Synchronous dispatch + fetch (warmup and --pipeline-depth 1)."""
        try:
            out = self._dispatch(group)
        except Exception as exc:                  # noqa: BLE001 — fan out
            out = exc
        self._finish(group, out)

    def close(self):
        """Stop the worker threads (tests; servers run them for life).

        Idle dispatch workers and the gatherer park on blocking queue
        gets — post one sentinel per thread.  Letting dozens of test
        batchers leak ~20 daemon threads each left hundreds of live
        threads in the suite process, implicated in a native-level
        crash; explicit teardown keeps the count flat."""
        self.queue.put(None)                       # wake the gatherer
        if self.depth > 1:
            for _ in range(self.workers):
                self._dispatch_q.put(None)
        if self._direct_pool is not None:
            self._direct_pool.shutdown(wait=True, cancel_futures=True)

    def _dispatch_loop(self):
        """One worker = one batch's full device round trip at a time.

        Dispatch (np.stack + upload + program queue) and fetch
        (np.asarray) both release the GIL while the device works, so N
        workers overlap N batches, as the unbatched path does with its
        handler threads."""
        while True:
            group = self._dispatch_q.get()
            if group is None:                      # close() sentinel
                return
            n = len(group)
            with self._cap_cv:
                # Frame-based backpressure (see __init__); a group alone
                # always passes so oversized groups cannot deadlock.
                while (self._inflight_frames
                       and self._inflight_frames + n > self.frame_cap):
                    self._cap_cv.wait()
                self._inflight_frames += n
            with self._stats_lock:
                self.inflight += 1
            try:
                try:
                    out = self._dispatch(group)
                except Exception as exc:          # noqa: BLE001 — fan out
                    out = exc
                self._finish(group, out)
            finally:
                with self._stats_lock:
                    self.inflight -= 1
                with self._cap_cv:
                    self._inflight_frames -= n
                    self._cap_cv.notify_all()

    def _gather(self, parked):
        """Form the next batch: oldest request leads; same-key requests
        join until the leader's linger deadline; others park.

        Past the deadline the queue is still drained non-blocking: under
        sustained load companions arrive while the previous batch
        computes, so by the time a backlogged leader is pulled its linger
        window has usually already expired — without the drain every
        batch would degenerate to size 1 exactly in the overload regime
        batching exists for."""
        job = parked.pop(0) if parked else self.queue.get()
        if job is None:                            # close() sentinel
            return None
        key = job.key
        group = [job]
        deadline = job.t0 + self.linger
        while len(group) < self.eff_batch:
            i = next((k for k, p in enumerate(parked)
                      if p.key == key), None)
            if i is not None:
                group.append(parked.pop(i))
                continue
            remaining = deadline - time.monotonic()
            try:
                nxt = (self.queue.get_nowait() if remaining <= 0
                       else self.queue.get(timeout=remaining))
            except queue.Empty:
                break
            if nxt is None:                        # close() sentinel:
                self.queue.put(None)               # re-post for _loop
                break
            if nxt.key == key:
                group.append(nxt)
            else:
                parked.append(nxt)
        return group

    def _loop(self):
        parked = []
        while True:
            group = self._gather(parked)
            if group is None:                      # close() sentinel
                return
            if self.depth <= 1:
                self._run(group)
                continue
            # Blocks when every dispatch worker is busy and one batch
            # is already waiting: backpressure bounds device-resident
            # batches at workers + 1 while the backlog coalesces.
            self._dispatch_q.put(group)


class _State:
    """Pipeline + counters shared across handler threads.  Unbatched:
    device calls serialize through one lock (JAX dispatch is per-process
    anyway — decode/encode are the parts worth overlapping).  Batched:
    the _Batcher worker owns all device calls."""

    def __init__(self, args):
        self.args = args
        self.batcher = (_Batcher(args)
                        if args.batch > 1 or args.mesh else None)
        self.pipeline = None if self.batcher else _build_pipeline(args)
        self.frames = 0
        self.lock = threading.Lock()
        self._latencies = []            # rolling window, seconds
        self._stages = {}               # stage name -> rolling seconds

    def record_latency(self, seconds: float, keep: int = 512):
        with self.lock:
            self._latencies.append(seconds)
            if len(self._latencies) > keep:
                del self._latencies[:-keep]

    def record_stage(self, name: str, seconds: float, keep: int = 512):
        """Per-request stage split (decode / compute / encode) — the
        instrumentation that tells host-bound from device-bound."""
        with self.lock:
            window = self._stages.setdefault(name, [])
            window.append(seconds)
            if len(window) > keep:
                del window[:-keep]

    def latency_stats(self):
        with self.lock:
            lat = sorted(self._latencies)
        if not lat:
            return None
        return {"window": len(lat),
                "p50_ms": round(lat[len(lat) // 2] * 1e3, 1),
                "p95_ms": round(lat[int(len(lat) * 0.95)] * 1e3, 1)}

    def stage_stats(self):
        with self.lock:
            snap = {k: sorted(v) for k, v in self._stages.items() if v}
        return {k: {"p50_ms": round(v[len(v) // 2] * 1e3, 2),
                    "p95_ms": round(v[int(len(v) * 0.95)] * 1e3, 2)}
                for k, v in snap.items()} or None

    def estimate(self, left, right, refine: bool, speckle: bool = False,
                 count: bool = True):
        if self.batcher is not None:
            out = self.batcher.estimate(left, right, refine, speckle)
            if count:
                with self.lock:
                    self.frames += 1
            return out
        import jax
        import jax.numpy as jnp
        # Upload in the request dtype (uint8: 4x fewer bytes to copy),
        # widen to float32 on device — exact for 8-bit values.
        left = jax.device_put(left).astype(jnp.float32)
        right = jax.device_put(right).astype(jnp.float32)
        with self.lock:
            a = self.args
            flat = a.pyramid == 0
            wmf = a.wmf and flat
            lr = a.lr_check and flat
            fgs = a.fgs if flat else None
            if refine or wmf or lr or fgs is not None:
                kwargs = {}
                if flat:
                    kwargs = dict(weighted_median=wmf,
                                  wmf_sigma=a.wmf_sigma,
                                  lr_check=lr, lr_mode=a.lr_mode,
                                  fgs_lambda=fgs, fgs_sigma=a.fgs_sigma)
                out = self.pipeline.estimate_refined(
                    left, right, subpixel=refine, median=refine, **kwargs)
            else:
                out = self.pipeline.estimate(left, right)
            if speckle:
                import jax.numpy as jnp

                from ..ops.refine import filter_speckles
                out = filter_speckles(out.astype(jnp.float32),
                                      fill="background")
            if count:
                self.frames += 1
            return _narrow_for_fetch(out, self.args.max_disparity)


def _make_handler(state: _State):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *hargs):        # quiet by default
            pass

        def _reply(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.split("?")[0] != "/healthz":
                self._reply(404, b'{"error": "not found"}')
                return
            a = state.args
            info = {"status": "ok", "frames_served": state.frames,
                    "max_disparity": a.max_disparity,
                    "config": (f"pyramid{a.pyramid}" if a.pyramid
                               else "-".join(filter(None, [
                                   a.cost_method, a.disparity_method,
                                   a.aggregation_method]))),
                    "dtype": a.dtype, "backend": a.backend}
            if state.batcher is not None:
                b = state.batcher
                info["batching"] = {
                    "max_batch": b.max_batch,
                    "linger_ms": a.linger_ms,
                    "mesh": a.mesh,
                    "batches": b.batches,
                    "batched_frames": b.batched_frames,
                    "padded_frames": b.padded_frames,
                    "effective_batch": b.eff_batch,
                    "dispatch_workers": b.workers,
                    "in_flight_dispatches": b.inflight,
                    "device_ms_per_frame": round(
                        b.device_s / max(b.batched_frames, 1) * 1e3, 2),
                    "queue_ms_per_frame": round(
                        b.queue_s / max(b.batched_frames, 1) * 1e3, 2),
                }
            stats = state.latency_stats()
            if stats is not None:
                info["latency"] = stats
            stages = state.stage_stats()
            if stages is not None:
                info["stages"] = stages
            self._reply(200, json.dumps(info).encode())

        # Drop handlers whose socket stalls instead of blocking the
        # worker thread forever (BaseHTTPRequestHandler honors this).
        timeout = 30
        _MAX_BODY = 64 * 1024 * 1024     # generous for any stereo frame

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse
            import numpy as np

            url = urlparse(self.path)
            if url.path != "/estimate":
                self._reply(404, b'{"error": "not found"}')
                return
            q = parse_qs(url.query)
            fmt = q.get("format", ["png16"])[0]
            refine = q.get("refine", ["0"])[0] in ("1", "true")
            speckle = q.get("speckle", ["0"])[0] in ("1", "true")

            # Client-fault stages -> 400; anything past decode is a
            # server fault -> 500 (a dead device must not look like a
            # stream of bad clients to load balancers).
            t_start = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if not 0 < length <= self._MAX_BODY:
                    raise ValueError(
                        f"Content-Length must be in (0, {self._MAX_BODY}]")
                if fmt not in ("png16", "png", "pfm", "npy"):
                    raise ValueError(f"unknown format {fmt!r}")
                from ..io.capture import split_side_by_side
                body = self.rfile.read(length)
                if body[:6] == b"\x93NUMPY":
                    # Raw .npy side-by-side grayscale [H, 2W] — machine
                    # clients skip image encode/decode entirely.
                    gray = np.load(io.BytesIO(body), allow_pickle=False)
                    if gray.ndim != 2:
                        raise ValueError(
                            f"npy body must be [H, 2W] grayscale, got "
                            f"shape {gray.shape}")
                else:
                    from PIL import Image
                    img = Image.open(io.BytesIO(body))
                    # Keep uint8 across the host->device upload (4x fewer
                    # bytes); the compiled
                    # programs widen to float32 on device, which is exact
                    # for 8-bit values.
                    gray = np.asarray(img.convert("L"), np.uint8)
                pair = split_side_by_side(gray)
                left, right = np.asarray(pair.left), np.asarray(pair.right)
                a = state.args
                if a.mesh and a.pyramid:
                    # The sharded pyramid cannot edge-pad inside
                    # shard_map; reject cleanly instead of surfacing an
                    # XLA reshape error as a 500 (mirrors the stm-video
                    # --mesh --pyramid guard).
                    scale = 2 ** a.pyramid
                    h, w = left.shape
                    if h % scale or w % scale:
                        raise ValueError(
                            f"--mesh --pyramid {a.pyramid} needs frame "
                            f"sides divisible by {scale}; got {h}x{w}")
            except Exception as exc:     # noqa: BLE001 — client fault
                self._reply(400, json.dumps({"error": str(exc)}).encode())
                return
            try:
                t0 = time.perf_counter()
                state.record_stage("decode", t0 - t_start)
                disp = np.asarray(state.estimate(left, right, refine,
                                                 speckle))
                t1 = time.perf_counter()
                state.record_stage("compute", t1 - t0)
                body, ctype = _encode(disp, fmt, state.args.max_disparity)
                state.record_stage("encode", time.perf_counter() - t1)
                state.record_latency(time.perf_counter() - t0)
            except Exception as exc:     # noqa: BLE001 — server fault
                self._reply(500, json.dumps({"error": str(exc)}).encode())
                return
            self._reply(200, body, ctype)

    return Handler


def make_server(args) -> ThreadingHTTPServer:
    """Build (but don't run) the server — the test seam; ``server_port``
    reports the bound port when ``--port 0`` asked for an ephemeral one."""
    if args.batch < 1:
        raise ValueError("--batch must be >= 1")
    if args.dtype == "auto":
        args.dtype = "float32"
    state = _State(args)
    if args.warmup:
        import numpy as np
        h, w = (int(v) for v in args.warmup.split("x"))
        # uint8, matching live request traffic (the handler uploads the
        # decoded 8-bit frames as-is), so the warm programs are the ones
        # requests actually hit.
        z = np.zeros((h, w), np.uint8)
        # Every (refine, speckle) flag combination is a distinct XLA
        # program; a live request must never be the first to compile
        # one.
        for refine in (False, True):
            for speckle in (False, True):
                if state.batcher is not None:
                    # Compile every padded batch size (1, 2, ...,
                    # max_batch) up front, so no live batch pays a
                    # compile.
                    state.batcher.warmup(z, z, refine=refine,
                                         speckle=speckle)
                else:
                    state.estimate(z, z, refine=refine, speckle=speckle,
                                   count=False)
    server = ThreadingHTTPServer((args.host, args.port),
                                 _make_handler(state))
    server.stm_state = state            # introspection / test seam
    if state.batcher is not None:
        # server_close also stops the batcher's worker threads (tests
        # build many servers; leaked daemons implicated in a native
        # crash under the full suite).
        orig_close = server.server_close

        def _close_all():
            orig_close()
            state.batcher.close()

        server.server_close = _close_all
    return server


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.wmf and args.pyramid > 0:
        print("--wmf is incompatible with --pyramid (the band stage has "
              "no integer disparity/bin range to median over).",
              file=sys.stderr)
        return 2
    if args.lr_check and args.pyramid > 0:
        print("--lr-check is incompatible with --pyramid (no full cost "
              "volume to re-index).", file=sys.stderr)
        return 2
    if args.fgs is not None and args.pyramid > 0:
        print("--fgs is incompatible with --pyramid (no flat "
              "post-processing stage there).", file=sys.stderr)
        return 2
    from ..cli_common import setup_runtime
    setup_runtime(args.device)
    server = make_server(args)

    # Orchestrators stop containers with SIGTERM: treat it like Ctrl-C so
    # in-flight handlers finish and the socket closes cleanly.  Installed
    # before the banner (which tells a supervisor the server is up), and
    # the banner is inside the try, so a signal right after it is caught.
    import signal

    def _terminate(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _terminate)
    try:
        print(f"stm-serve listening on http://{args.host}:"
              f"{server.server_port} (D={args.max_disparity})",
              file=sys.stderr, flush=True)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
