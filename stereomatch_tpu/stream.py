"""Batched streaming estimation for stereo video.

The reference's video loop (stereomatch/cli_video.py:77-124) is strictly
frame-at-a-time: capture, upload, estimate (with per-op device sync),
display.  The steady state here instead:

* batches B frames into one [B, H, W] device array so every kernel runs at
  batch width (vmapped over the same jitted pipeline),
* relies on XLA async dispatch to overlap the host->device copy of batch
  k+1 with compute of batch k (no explicit double-buffer bookkeeping),
* optionally decodes on libstmio's native prefetch thread (io.capture
  .Y4MCapture), so file I/O, decode, H2D and compute all pipeline.

``StreamingEstimator`` is single-chip; hand a ``parallel.ShardedPipeline``
the same batches to span a mesh.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops.cvf import guided_filter_aggregate
from .ops.cost import (birchfield_cost_volume, census_hamming_cost_volume,
                       sad_cost_volume, ssd_cost_volume, zncc_cost_volume)
from .ops.disparity import dynamic_programming, winner_takes_all
from .utils.backend import resolve_backend, semiglobal_fn


def _widen_host(host: "np.ndarray") -> "np.ndarray":
    """Undo the fetch narrowing on the host: unsigned fetch dtypes widen
    back to the int32 the yield contract promises (float passes through)."""
    if np.issubdtype(host.dtype, np.unsignedinteger):
        return host.astype(np.int32)
    return host


@dataclass
class StreamStats:
    frames: int = 0
    batches: int = 0
    seconds: float = 0.0
    # Wall-clock stage split: where the video loop's time actually goes.  decode = capture.read_next +
    # grayscale/split; dispatch = estimate_batch (host stack + upload +
    # async XLA enqueue); fetch = blocking device->host result reads.
    # The remainder of ``seconds`` is yield/consumer time.
    decode_s: float = 0.0
    dispatch_s: float = 0.0
    fetch_s: float = 0.0
    _start: Optional[float] = field(default=None, repr=False)

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds > 0 else 0.0

    def stage_ms_per_frame(self) -> dict:
        n = max(self.frames, 1)
        other = max(self.seconds - self.decode_s - self.dispatch_s
                    - self.fetch_s, 0.0)
        return {k: round(v / n * 1e3, 2) for k, v in [
            ("decode", self.decode_s), ("dispatch", self.dispatch_s),
            ("fetch", self.fetch_s), ("other", other),
            ("total", self.seconds)]}


def _build_frame_fn(max_disparity: int, cost: str, kernel_size: Optional[int],
                    aggregation: Optional[str], reducer: str,
                    penalty1: float, penalty2: float,
                    backend: str = "auto", cost_dtype=jnp.float32,
                    cvf_radius: int = 8, cvf_eps: float = 1e-4,
                    census_window: int = 5,
                    median: bool = False, subpixel: bool = False,
                    lr_check: bool = False, lr_mode: str = "volume",
                    lr_max_diff: int = 1,
                    weighted_median: bool = False, wmf_sigma: float = 10.0,
                    wmf_window: int = 5,
                    fgs_lambda=None, fgs_sigma: float = 8.0,
                    speckle: bool = False, speckle_fill: str = "zero"):
    if lr_mode not in ("mirror", "volume"):
        raise ValueError(f"unknown lr_mode: {lr_mode!r}")
    if kernel_size is None:
        kernel_size = {"birchfield": 4, "census": 1}.get(cost, 7)
    if cost == "ssd-texture":
        cost_dtype = jnp.float32        # the sampler contract is float32
    sgm_backend = resolve_backend(backend)

    def postprocess(vol, disp, left, disp_r):
        from .ops import refine
        mask = None
        if lr_check:
            if disp_r is None:      # lr_mode == "volume"
                disp_r = refine.right_disparity_from_volume.__wrapped__(vol)
            mask = refine.left_right_consistency.__wrapped__(
                disp, disp_r, lr_max_diff, max_disparity=max_disparity)
            disp = refine.fill_inconsistent(disp, mask)
        if weighted_median:
            disp = refine.weighted_median_filter.__wrapped__(
                disp, left, window=wmf_window, sigma=wmf_sigma,
                n_bins=max_disparity)
        if median:
            disp = refine.median_filter_3x3.__wrapped__(disp)
        if subpixel:
            idx = jnp.clip(jnp.round(disp), 0,
                           max_disparity - 1).astype(jnp.int32)
            disp = refine.subpixel_refine.__wrapped__(vol, idx)
        if fgs_lambda is not None:
            conf = mask.astype(jnp.float32) if lr_check else None
            disp = refine.fgs_smooth.__wrapped__(
                disp.astype(jnp.float32), left, lam=fgs_lambda,
                sigma_color=fgs_sigma, confidence=conf)
        if speckle:
            disp = refine.filter_speckles.__wrapped__(
                disp.astype(jnp.float32), fill=speckle_fill)
        return disp

    def core(left, right):
        if cost in ("ssd", "ssd-texture"):
            vol = ssd_cost_volume(left, right, max_disparity=max_disparity,
                                  kernel_size=kernel_size,
                                  cost_dtype=cost_dtype)
        elif cost == "birchfield":
            vol = birchfield_cost_volume(left, right,
                                         max_disparity=max_disparity,
                                         kernel_size=kernel_size)
        elif cost == "sad":
            vol = sad_cost_volume(left, right, max_disparity=max_disparity,
                                  kernel_size=kernel_size,
                                  cost_dtype=cost_dtype)
        elif cost == "ncc":
            vol = zncc_cost_volume(left, right, max_disparity=max_disparity,
                                   kernel_size=kernel_size,
                                   cost_dtype=cost_dtype)
        elif cost == "census":
            vol = census_hamming_cost_volume(left, right,
                                             max_disparity=max_disparity,
                                             window_size=census_window,
                                             kernel_size=kernel_size,
                                             cost_dtype=cost_dtype)
        else:
            raise ValueError(f"unknown cost {cost!r}")
        if aggregation == "sgm":
            agg = semiglobal_fn(sgm_backend)
            vol = agg(vol, left, penalty1=penalty1, penalty2=penalty2)
        elif aggregation == "cvf":
            # wedge_offset=0 as in cli_common.create_pipeline: every cost
            # family above writes +inf at exactly the x < d wedge.
            vol = guided_filter_aggregate(vol, left, radius=cvf_radius,
                                          eps=cvf_eps, wedge_offset=0)
        elif aggregation is not None:
            raise ValueError(f"unknown aggregation {aggregation!r}")
        if reducer == "wta":
            return vol, winner_takes_all(vol)
        if reducer == "dynamic_programming":
            return vol, dynamic_programming(vol)
        raise ValueError(f"unknown reducer {reducer!r}")

    def frame_fn(left, right):
        disp_r = None
        if lr_check and lr_mode == "mirror":
            disp_r = core(right[:, ::-1], left[:, ::-1])[1][:, ::-1]
        vol, disp = core(left, right)
        return postprocess(vol, disp, left, disp_r)

    return frame_fn


class StreamingEstimator:
    """Batched jitted estimator over stereo frame streams.

    Single-chip by default; pass a ``(batch, tile)`` ``mesh`` (e.g. from
    ``parallel.make_hybrid_mesh``) to span chips/hosts — frames then split
    over the mesh batch axis and image rows over the tile axis with the
    full ShardedPipeline program (BASELINE "batched pairs across hosts"
    config), behind the same run()/estimate_batch interface.

    ``pyramid_levels`` > 0 switches every frame to the coarse-to-fine
    census pyramid (single-chip ``PyramidPipeline`` under ``lax.map``, or
    ``parallel.pyramid_sharded`` on a mesh); the census-based pyramid
    ignores ``cost``/``aggregation``/``reducer``, and its inter-level
    3x3 filter is governed by ``pyramid_median`` (default on — the
    post-reducer ``median`` knob applies to the flat paths only).
    """

    def __init__(self, max_disparity: int, *, batch: int = 4,
                 depth: int = 2,
                 cost: str = "ssd", kernel_size: Optional[int] = None,
                 cost_dtype=jnp.float32, census_window: int = 5,
                 aggregation: Optional[str] = "sgm", reducer: str = "wta",
                 penalty1: float = 0.1, penalty2: float = 0.2,
                 cvf_radius: int = 8, cvf_eps: float = 1e-4,
                 fetch_workers: int = 4,
                 backend: str = "auto", mesh=None,
                 sgm_mode: str = "exact", overlap: int = 64,
                 pyramid_levels: int = 0, band_radius: int = 24,
                 pyramid_median: bool = True,
                 median: bool = False, subpixel: bool = False,
                 lr_check: bool = False, lr_mode: str = "volume",
                 lr_max_diff: int = 1,
                 weighted_median: bool = False, wmf_sigma: float = 10.0,
                 wmf_window: int = 5,
                 fgs_lambda=None, fgs_sigma: float = 8.0,
                 speckle: bool = False, speckle_fill: str = "zero"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.max_disparity = max_disparity
        # Batches kept in flight by run() before a blocking fetch: 1 =
        # fully synchronous, 2 = overlap one batch's compute with the
        # next batch's decode (the prior default), higher = deeper
        # overlap against transports whose fetch round trip exceeds a
        # batch's compute (identical results — frames still yield in
        # order).
        self.depth = depth
        # Result-fetch concurrency: device->host fetches run on a pool of
        # this many threads so they overlap decode, dispatch and each
        # other.  Effective concurrency is min(fetch_workers, depth) — the
        # loop keeps at most ``depth`` batches in flight.
        self.fetch_workers = max(int(fetch_workers), 1)
        if pyramid_levels > 0:
            wanted = [name for name, on in [
                ("lr_check", lr_check), ("weighted_median", weighted_median),
                ("fgs_lambda", fgs_lambda is not None)] if on]
            if wanted:
                raise ValueError(
                    f"pyramid_levels > 0 does not support {wanted}: the "
                    "band stage has no full cost volume / flat "
                    "post-processing stage (silently skipping them would "
                    "misreport what ran)")
        if mesh is not None:
            from .parallel.mesh import BATCH_AXIS
            n_batch = mesh.shape[BATCH_AXIS]
            # Frames per step must fill the mesh batch axis exactly:
            # round the request UP to the next multiple.
            self.batch = -(-max(batch, n_batch) // n_batch) * n_batch
            if pyramid_levels > 0:
                # Coarse-to-fine path: census-based by construction, so
                # cost/aggregation/reducer selections do not apply.
                from .parallel.pyramid_sharded import \
                    make_pyramid_sharded_estimate
                self._fn = make_pyramid_sharded_estimate(
                    mesh, max_disparity=max_disparity, levels=pyramid_levels,
                    band_radius=band_radius, cost_dtype=cost_dtype,
                    penalty1=penalty1, penalty2=penalty2, sgm_mode=sgm_mode,
                    overlap=overlap, backend=backend, subpixel=subpixel,
                    median=pyramid_median,
                    speckle=speckle, speckle_fill=speckle_fill)
            else:
                from .parallel.sharded import make_sharded_estimate
                self._fn = make_sharded_estimate(
                    mesh, max_disparity=max_disparity, cost=cost,
                    kernel_size=kernel_size, cost_dtype=cost_dtype,
                    census_window=census_window, aggregation=aggregation,
                    reducer=reducer, penalty1=penalty1, penalty2=penalty2,
                    cvf_radius=cvf_radius, cvf_eps=cvf_eps,
                    sgm_mode=sgm_mode, overlap=overlap, backend=backend,
                    median=median, subpixel=subpixel,
                    lr_check=lr_check, lr_mode=lr_mode,
                    lr_max_diff=lr_max_diff,
                    weighted_median=weighted_median, wmf_sigma=wmf_sigma,
                    wmf_window=wmf_window,
                    fgs_lambda=fgs_lambda, fgs_sigma=fgs_sigma,
                    speckle=speckle, speckle_fill=speckle_fill)
        else:
            self.batch = batch
            if pyramid_levels > 0:
                from .pyramid import PyramidPipeline
                pyr = PyramidPipeline(max_disparity, levels=pyramid_levels,
                                      band_radius=band_radius,
                                      median=pyramid_median,
                                      penalty1=penalty1, penalty2=penalty2,
                                      cost_dtype=cost_dtype, backend=backend)
                pyr_fn = lambda l, r: pyr._estimate(l, r, subpixel)  # noqa: E731
                if speckle:
                    from .ops.refine import filter_speckles
                    frame_fn = lambda l, r: filter_speckles.__wrapped__(  # noqa: E731
                        pyr_fn(l, r), fill=speckle_fill)
                else:
                    frame_fn = pyr_fn
            else:
                frame_fn = _build_frame_fn(max_disparity, cost, kernel_size,
                                           aggregation, reducer, penalty1,
                                           penalty2, backend, cost_dtype,
                                           cvf_radius=cvf_radius,
                                           cvf_eps=cvf_eps,
                                           census_window=census_window,
                                           median=median, subpixel=subpixel,
                                           lr_check=lr_check,
                                           lr_mode=lr_mode,
                                           lr_max_diff=lr_max_diff,
                                           weighted_median=weighted_median,
                                           wmf_sigma=wmf_sigma,
                                           wmf_window=wmf_window,
                                           fgs_lambda=fgs_lambda,
                                           fgs_sigma=fgs_sigma,
                                           speckle=speckle,
                                           speckle_fill=speckle_fill)
            # lax.map runs the single-frame program back to back inside
            # one jit (per-frame buffers stay single-frame sized).
            self._fn = jax.jit(
                lambda l, r: jax.lax.map(lambda p: frame_fn(*p), (l, r)))
        self.stats = StreamStats()

    def estimate_batch(self, left: np.ndarray, right: np.ndarray):
        """[B, H, W] pair stack -> [B, H, W] int32 disparity (device array).

        Returns without blocking: XLA queues the work, so callers can feed
        the next batch while this one computes.

        Frames upload in their storage dtype and widen to float32 on
        device — for the common uint8 video frames that is 4x fewer
        host->device bytes (exact: 8/16-bit integers are representable
        in float32).
        """
        return self._fn(jnp.asarray(left).astype(jnp.float32),
                        jnp.asarray(right).astype(jnp.float32))

    def _narrow_for_fetch(self, out):
        """Device-side cast before the host fetch: integer disparities
        are < max_disparity, so uint8 (D <= 256) / uint16 is lossless
        and cuts the result-fetch bytes 4x/2x.  Float (sub-pixel/FGS)
        outputs pass
        through; run() widens integers back to int32 on the host, so
        the yielded dtype contract is unchanged."""
        if out.dtype == jnp.int32:
            return out.astype(jnp.uint8 if self.max_disparity <= 256
                              else jnp.uint16)
        return out

    def run(self, capture, max_frames: Optional[int] = None
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Drive a capture (read_next() protocol) to completion.

        Yields (gray_left [H, W], disparity [H, W] int32) per frame, in
        order, keeping up to ``depth`` batches in flight.  Result
        fetches run on a background pool of ``fetch_workers`` threads,
        so they overlap decode, dispatch and each other.  Frame
        order, values, and the yielded dtype are unchanged: ``pending``
        is popped in submission order and each future resolves
        independently (``np.asarray`` releases the GIL during the
        transfer).
        """
        from concurrent.futures import ThreadPoolExecutor
        self.stats = StreamStats()
        self.stats._start = time.perf_counter()
        fetcher = ThreadPoolExecutor(
            max_workers=min(self.fetch_workers, max(self.depth, 1)),
            thread_name_prefix="stm-fetch")
        pending: List[Tuple[List[np.ndarray], object]] = []
        lefts_buf: List[np.ndarray] = []
        rights_buf: List[np.ndarray] = []
        done = False
        try:
            yield from self._run_loop(capture, max_frames, fetcher,
                                      pending, lefts_buf, rights_buf, done)
        finally:
            # Consumer may abandon the generator early (stm-video 'q'):
            # cancel queued fetches, but WAIT for the running ones — an
            # abandoned np.asarray executing while the caller tears
            # down/rebuilds jax state is a native-level race (a pure-C
            # XLA thread segfaulted exactly there in the round-5 suite).
            # On normal completion every future is already resolved, so
            # the wait costs nothing.
            fetcher.shutdown(wait=True, cancel_futures=True)
            self.stats.seconds = time.perf_counter() - self.stats._start

    def _run_loop(self, capture, max_frames, fetcher, pending,
                  lefts_buf, rights_buf, done):
        while not done:
            t = time.perf_counter()
            ok, img = capture.read_next()
            if ok:
                gray = img if not hasattr(img, "to_grayscale") else \
                    img.to_grayscale()
                left, right = np.asarray(gray.left), np.asarray(gray.right)
                lefts_buf.append(left)
                rights_buf.append(right)
                self.stats.frames += 1
                if max_frames is not None and self.stats.frames >= max_frames:
                    done = True
            else:
                done = True
            self.stats.decode_s += time.perf_counter() - t

            if len(lefts_buf) == self.batch or (done and lefts_buf):
                pad = 0
                lefts = lefts_buf
                rights = rights_buf
                if len(lefts) < self.batch:
                    pad = self.batch - len(lefts)
                    lefts = lefts + [lefts[-1]] * pad
                    rights = rights + [rights[-1]] * pad
                t = time.perf_counter()
                out = self._narrow_for_fetch(
                    self.estimate_batch(np.stack(lefts), np.stack(rights)))
                self.stats.dispatch_s += time.perf_counter() - t
                if pad:
                    out = out[:self.batch - pad]
                pending.append((lefts_buf, fetcher.submit(np.asarray, out)))
                self.stats.batches += 1
                lefts_buf, rights_buf = [], []
                # Keep at most ``depth`` batches in flight; block on the
                # oldest fetch beyond that (stats count only the BLOCKED
                # portion — the overlapped transfer time is the win).
                while len(pending) >= self.depth:
                    ready_lefts, fut = pending.pop(0)
                    t = time.perf_counter()
                    host = _widen_host(fut.result())
                    self.stats.fetch_s += time.perf_counter() - t
                    for i, disp in enumerate(host):
                        yield ready_lefts[i], disp

        for ready_lefts, fut in pending:
            t = time.perf_counter()
            host = _widen_host(fut.result())
            self.stats.fetch_s += time.perf_counter() - t
            for i, disp in enumerate(host):
                yield ready_lefts[i], disp
