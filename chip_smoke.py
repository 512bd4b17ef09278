#!/usr/bin/env python3
"""Smoke test of the main path on one NVIDIA H100 — or four with --multi.

    python3 chip_smoke.py            # one card
    python3 chip_smoke.py --multi    # four cards: the sharded path only

One card, in order (every phase checks its output; any failure exits
non-zero before the result line):

1. gpu-tests — ``pytest -m gpu tests/test_gpu_hardware.py`` in a
   subprocess that ends before this process starts JAX (one JAX process
   per card at a time);
2. teddy — SSD -> SGM -> WTA through ``create_pipeline(...).compiled()``
   at 375x450, D=128, f32: the Hopper kernel's aggregated volume against
   XLA's ``semiglobal_aggregate`` on the card, WTA on a distinct-value
   volume, the pipeline against the XLA pipeline, compile times (cold and
   from the persistent cache) and the median step time;
3. hd-bf16 — census -> SGM -> WTA at 1024x1280, D=256, bf16 volume, kernel
   against the XLA bf16 path;
4. cvf — census -> CVF -> WTA at teddy size, card against the host CPU;
5. stream — ``StreamingEstimator`` with a batch of 4, against the pipeline;
6. serve — ``stm-serve``'s server answering three raw .npy side-by-side
   requests, against the pipeline.

``--multi`` runs ``ShardedPipeline`` over four cards at (batch=1, tile=4)
in exact and overlap mode and at (batch=2, tile=2), each against the
one-card pipeline, and reports which SGM mode the interconnect model
picks and which measured faster.

Scenes come from the seeded generators in ``stereomatch_tpu.io.synthetic``.
The card's name and power limit (nvidia-smi) precede the last line, which
is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import argparse
import io
import json
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent
TEDDY = (375, 450, 128)
HD = (1024, 1280, 256)
MULTI = (376, 450, 128)        # teddy width, height divisible by 4 tiles


class PhaseFailed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


# -- phases -----------------------------------------------------------------

def phase_gpu_tests():
    cmd = [sys.executable, "-m", "pytest", "-m", "gpu",
           "tests/test_gpu_hardware.py", "-q", "-rs", "-p", "no:cacheprovider"]
    start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    lines = proc.stdout.strip().splitlines()
    tail = lines[-1] if lines else proc.stderr.strip()[-300:]
    log(f"[gpu-tests] check: every hardware-tier test passes, none skipped "
        f"(exact, bit-level or stated tolerances in the tests); "
        f"exit {proc.returncode}: {tail} "
        f"({time.perf_counter() - start:.1f} s)")
    if proc.returncode != 0:
        log("\n".join(lines[-40:]))
    check(proc.returncode == 0 and " passed" in tail
          and "skipped" not in tail, "hardware tier did not pass cleanly")


def _scene(shape, seed):
    import jax

    from stereomatch_tpu.io.synthetic import stereo_pair
    h, w, d = shape
    left, right, gt = stereo_pair(h, w, d, seed=seed)
    return jax.device_put(left), jax.device_put(right), gt


def _cache_files(path):
    return sum(1 for p in Path(path).rglob("*") if p.is_file()) \
        if Path(path).exists() else 0


def phase_teddy(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from stereomatch_tpu.cli_common import create_pipeline
    from stereomatch_tpu.ops import sgm_cuda
    from stereomatch_tpu.ops.aggregation import semiglobal_aggregate
    from stereomatch_tpu.ops.cost import ssd_cost_volume
    from stereomatch_tpu.ops.disparity import winner_takes_all
    from stereomatch_tpu.utils import benchmarking
    from stereomatch_tpu.utils.backend import resolve_backend

    h, w, d = TEDDY
    check(resolve_backend("auto") == "cuda",
          "backend auto did not resolve to the Hopper kernel")
    start = time.perf_counter()
    sgm_cuda.build()
    log(f"[teddy] kernel library {sgm_cuda.library_path().name} ready in "
        f"{time.perf_counter() - start:.2f} s (set-up)")

    left, right, gt = _scene(TEDDY, seed=0)
    pipe = create_pipeline("ssd", "wta", "sgm", max_disparity=d)
    before = _cache_files(ctx["cache"])
    fn = pipe.compiled(donate=False)
    start = time.perf_counter()
    disp = np.asarray(jax.block_until_ready(fn(left, right)))
    first = time.perf_counter() - start
    jax.clear_caches()
    fn = pipe.compiled(donate=False)
    start = time.perf_counter()
    jax.block_until_ready(fn(left, right))
    cached = time.perf_counter() - start
    log(f"[teddy] compile+first run: {first:.3f} s with {before} files in "
        f"the persistent cache {ctx['cache']} "
        f"({'cold' if before == 0 else 'cache present'}); after clearing "
        f"the in-memory caches, from the persistent cache: {cached:.3f} s")

    vol = ssd_cost_volume(left, right, max_disparity=d, kernel_size=7)
    ref = np.asarray(semiglobal_aggregate(vol, left))
    out = np.asarray(sgm_cuda.semiglobal_aggregate_cuda(vol, left))
    finite = np.isfinite(ref)
    same_inf = bool(np.array_equal(finite, np.isfinite(out)))
    diff = np.abs(out[finite] - ref[finite])
    rel = float(np.max(diff / np.maximum(np.abs(ref[finite]), 1e-30)))
    close = bool(np.all(diff <= 1e-5 + 2e-6 * np.abs(ref[finite])))
    log(f"[teddy] check: kernel SGM volume vs XLA semiglobal_aggregate on "
        f"the card, f32, rtol 2e-6 / atol 1e-5 and identical +inf "
        f"pattern; max abs err {float(diff.max()):.3g}, max rel err "
        f"{rel:.3g}, bit-identical {bool(np.array_equal(out, ref))}")
    check(same_inf and close, "kernel SGM volume outside tolerance")

    rng = np.random.default_rng(1)
    dv = jnp.asarray(rng.permutation(h * w * d).reshape(h, w, d)
                     .astype(np.float32) / 4096.0)
    wk = np.asarray(winner_takes_all(sgm_cuda.semiglobal_aggregate_cuda(
        dv, left)))
    wx = np.asarray(winner_takes_all(semiglobal_aggregate(dv, left)))
    log(f"[teddy] check: WTA identical on a distinct-value volume "
        f"(exact int32); mismatching pixels {int(np.sum(wk != wx))}")
    check(np.array_equal(wk, wx), "WTA differs on a distinct-value volume")

    xla = create_pipeline("ssd", "wta", "sgm", max_disparity=d,
                          backend="xla").compiled(donate=False)
    dx = np.asarray(xla(left, right))
    bad = float(np.mean((np.abs(disp - gt) > 1)[:, d:]))
    log(f"[teddy] check: pipeline disparity (kernel) equals the XLA "
        f"pipeline (exact int32); mismatching pixels "
        f"{int(np.sum(disp != dx))}; bad-pixel vs ground truth {bad:.4f} "
        f"(limit 0.06)")
    check(np.array_equal(disp, dx) and bad < 0.06,
          "teddy pipeline disagrees with XLA or ground truth")

    step = benchmarking.summarize_ms(
        benchmarking.time_calls(fn, left, right, warmup=3, repeats=30))
    log(f"[teddy] median step {step['median_ms']:.4f} ms "
        f"(q1 {step['q1_ms']:.4f}, q3 {step['q3_ms']:.4f}, n {step['n']}) "
        f"= {1e3 / step['median_ms']:.2f} frames/s on {ctx['card']}")


def phase_hd_bf16(ctx):
    import numpy as np

    from stereomatch_tpu.cli_common import create_pipeline
    from stereomatch_tpu.utils import benchmarking

    d = HD[2]
    left, right, _ = _scene(HD, seed=5)
    kern = create_pipeline("census", "wta", "sgm", max_disparity=d,
                           volume_dtype="bfloat16").compiled(donate=False)
    xla = create_pipeline("census", "wta", "sgm", max_disparity=d,
                          volume_dtype="bfloat16",
                          backend="xla").compiled(donate=False)
    dk, dx = np.asarray(kern(left, right)), np.asarray(xla(left, right))
    agree = float(np.mean(dk == dx))
    log(f"[hd-bf16] check: census+SGM+WTA, bf16 volume, kernel vs XLA bf16 "
        f"path on the card, WTA agreement >= 0.995; agreement {agree:.6f}")
    check(agree >= 0.995, "HD bf16 WTA agreement below 99.5%")
    step = benchmarking.summarize_ms(
        benchmarking.time_calls(kern, left, right, warmup=2, repeats=10))
    log(f"[hd-bf16] median step {step['median_ms']:.3f} ms on {ctx['card']}")


def phase_cvf(ctx):
    import jax
    import numpy as np

    from stereomatch_tpu.cli_common import create_pipeline

    d = TEDDY[2]
    left, right, gt = _scene(TEDDY, seed=2)
    pipe = create_pipeline("census", "wta", "cvf", max_disparity=d)
    fn = jax.jit(pipe.estimate_fn())
    on_card = np.asarray(fn(left, right))
    cpu = jax.devices("cpu")[0]
    on_host = np.asarray(fn(jax.device_put(left, cpu),
                            jax.device_put(right, cpu)))
    agree = float(np.mean(on_card == on_host))
    bad = float(np.mean((np.abs(on_card - gt) > 1)[:, d:]))
    log(f"[cvf] check: census+CVF+WTA on the card vs the same program on "
        f"the host CPU, WTA agreement >= 0.999 (f32 box sums may round "
        f"differently); agreement {agree:.6f}; bad-pixel vs ground truth "
        f"{bad:.4f} (limit 0.10)")
    check(agree >= 0.999 and bad < 0.10, "CVF disagrees with the host")


def phase_stream(ctx):
    import numpy as np

    from stereomatch_tpu.cli_common import create_pipeline
    from stereomatch_tpu.io.synthetic import stereo_pair
    from stereomatch_tpu.stream import StreamingEstimator

    h, w, d = TEDDY
    pairs = [stereo_pair(h, w, d, seed=10 + i)[:2] for i in range(8)]

    class Frames:
        def __init__(self):
            self.i = 0

        def read_next(self):
            if self.i == len(pairs):
                return False, None
            left, right = pairs[self.i]
            self.i += 1
            return True, types.SimpleNamespace(left=left, right=right)

    est = StreamingEstimator(d, batch=4, cost="ssd")
    got = [disp for _, disp in est.run(Frames())]
    ref = create_pipeline("ssd", "wta", "sgm", max_disparity=d).compiled(
        donate=False)
    worst = max(int(np.sum(np.asarray(ref(l, r)) != g))
                for (l, r), g in zip(pairs, got))
    log(f"[stream] check: 8 frames in batches of 4 through "
        f"StreamingEstimator.run equal the per-frame pipeline (exact "
        f"int32); frames {len(got)}, worst mismatching pixels {worst}; "
        f"{est.stats.fps:.2f} frames/s end to end (compile included)")
    check(len(got) == len(pairs) and worst == 0,
          "streamed disparities differ from the pipeline")


def phase_serve(ctx):
    import numpy as np

    from stereomatch_tpu.cli.serve import build_parser, make_server
    from stereomatch_tpu.cli_common import create_pipeline
    from stereomatch_tpu.io.synthetic import stereo_pair

    h, w, d = TEDDY
    args = build_parser().parse_args(
        [str(d), "-cm", "ssd", "--host", "127.0.0.1", "--port", "0"])
    server = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    pipe = create_pipeline("ssd", "wta", "sgm", max_disparity=d)
    try:
        worst = 0
        for i in range(3):
            left, right, _ = stereo_pair(h, w, d, seed=20 + i)
            frame = (np.concatenate([left, right], axis=1) * 255).round()
            frame = frame.astype(np.uint8)
            buf = io.BytesIO()
            np.save(buf, frame)
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_port}/estimate?format=npy",
                data=buf.getvalue(), method="POST",
                headers={"Content-Type": "application/octet-stream"})
            start = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, body = resp.status, resp.read()
            latency = time.perf_counter() - start
            got = np.load(io.BytesIO(body)).astype(np.int32)
            ref = np.asarray(pipe.estimate(frame[:, :w].astype(np.float32),
                                           frame[:, w:].astype(np.float32)))
            mism = int(np.sum(got != ref))
            worst = max(worst, mism)
            log(f"[serve] request {i}: HTTP {status}, {latency * 1e3:.1f} ms "
                f"(first includes compile), mismatching pixels vs the "
                f"pipeline {mism}")
            check(status == 200, f"stm-serve answered HTTP {status}")
        log(f"[serve] check: three /estimate responses equal Pipeline."
            f"estimate on the same uint8 frames (exact int32); worst "
            f"mismatching pixels {worst}")
        check(worst == 0, "served disparities differ from the pipeline")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def phase_multi(ctx):
    import jax
    import numpy as np

    from stereomatch_tpu.cli_common import create_pipeline
    from stereomatch_tpu.parallel import ShardedPipeline, make_mesh
    from stereomatch_tpu.parallel.ici_model import (ici_traffic_model,
                                                    select_sgm_mode)
    from stereomatch_tpu.utils import benchmarking
    from stereomatch_tpu.utils.devices import device_spec

    devices = jax.devices()
    check(len(devices) == 4, f"--multi needs 4 devices, found {len(devices)}")
    h, w, d = MULTI
    pairs = [_scene((h, w, d), seed=30 + i) for i in range(2)]
    one = create_pipeline("ssd", "wta", "sgm", max_disparity=d).compiled(
        donate=False)
    refs = [np.asarray(one(l, r)) for l, r, _ in pairs]

    def stack(n):
        return (np.stack([np.asarray(p[0]) for p in pairs[:n]]),
                np.stack([np.asarray(p[1]) for p in pairs[:n]]))

    mode, info = select_sgm_mode(height=h, width=w, disp=d, tiles=4,
                                 batch=1, device_kind=devices[0].device_kind)
    log(f"[multi] interconnect model picks sgm_mode={mode!r} at (batch=1, "
        f"tile=4): {info}")
    spec = device_spec(devices[0].device_kind)

    def predicted(n_batch, n_tile, kwargs):
        rows = ici_traffic_model(
            height=h, width=w, disp=d, tiles=n_tile, batch=n_batch,
            overlap=kwargs.get("overlap", 64),
            link_gbps=spec.link_bytes_per_s / 1e9,
            hbm_gbps=spec.hbm_bytes_per_s / 1e9)
        row = next(r for r in rows if r["config"] == "sgm_"
                   + kwargs["sgm_mode"])
        return row["predicted_efficiency"]

    # One card on the same numpy inputs (host copy included, as below).
    single = benchmarking.summarize_ms(benchmarking.time_calls(
        one, *(np.asarray(a) for a in pairs[0][:2]), warmup=2,
        repeats=10))["median_ms"]
    log(f"[multi] one card, the same frame from the host: median step "
        f"{single:.3f} ms on {ctx['card']}")
    full = (4 - 1) * (h // 4)               # warm-up covering every tile
    times = {}
    for label, n_batch, n_tile, kwargs in [
            ("exact", 1, 4, dict(sgm_mode="exact")),
            ("overlap", 1, 4, dict(sgm_mode="overlap", overlap=full)),
            ("overlap64", 1, 4, dict(sgm_mode="overlap", overlap=64)),
            ("exact_b2t2", 2, 2, dict(sgm_mode="exact"))]:
        mesh = make_mesh(n_batch=n_batch, n_tile=n_tile)
        ids = sorted(dv.id for dv in mesh.devices.flat)
        check(len(set(ids)) == 4, f"mesh reuses a device: {ids}")
        pipe = ShardedPipeline(mesh, d, **kwargs)
        left, right = stack(n_batch)
        out = np.asarray(pipe.estimate(left, right))
        mism = [int(np.sum(o != r)) for o, r in zip(out, refs)]
        step = benchmarking.summarize_ms(benchmarking.time_calls(
            pipe.estimate, left, right, warmup=2, repeats=10))
        times[label] = step["median_ms"]
        # Scaling efficiency: this mesh's frames/s per card over one
        # card's frames/s.
        eff = single * n_batch / (4 * step["median_ms"])
        log(f"[multi] {label} (batch={n_batch}, tile={n_tile}) on devices "
            f"{ids}: mismatching pixels vs one card {mism}; median step "
            f"{step['median_ms']:.3f} ms on {ctx['card']}; scaling "
            f"efficiency measured {eff:.3f}, model "
            f"{predicted(n_batch, n_tile, kwargs):.3f}")
        if label == "overlap64":
            continue                        # warm-up approximation: report
        check(max(mism) == 0, f"{label} differs from the one-card pipeline")
    faster = min(("exact", "overlap"), key=times.get)
    log(f"[multi] check: exact, covering-overlap and (2, 2) WTA equal the "
        f"one-card pipeline (exact int32): passed; measured faster at "
        f"(1, 4): {faster} ({times['exact']:.3f} vs "
        f"{times['overlap']:.3f} ms); the model picked {mode}")


# -- driver -----------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-card sharded path and its "
                             "one-card comparison")
    args = parser.parse_args(argv)
    if not (REPO / "stereomatch_tpu" / "__init__.py").exists():
        print(f"chip_smoke: the stereomatch_tpu package is not beside "
              f"{Path(__file__).name}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from stereomatch_tpu.utils.benchmarking import card
    ctx = {"card": card()}
    log(f"card: {ctx['card']}")
    try:
        if not args.multi:
            phase_gpu_tests()
        import jax

        from stereomatch_tpu.utils.compile_cache import enable_compile_cache
        ctx["cache"] = enable_compile_cache()
        check(jax.default_backend() != "cpu",
              "no accelerator: JAX's default backend is the CPU")
        phases = ([phase_multi] if args.multi else
                  [phase_teddy, phase_hd_bf16, phase_cvf, phase_stream,
                   phase_serve])
        for phase in phases:
            start = time.perf_counter()
            phase(ctx)
            log(f"[{phase.__name__[6:]}] passed in "
                f"{time.perf_counter() - start:.1f} s")
    except PhaseFailed as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    log(card())                  # as nvidia-smi prints it: name, power.limit
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
