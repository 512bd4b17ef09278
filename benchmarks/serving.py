"""End-to-end stm-serve throughput: HTTP requests/s with and without
request micro-batching.

Unlike the stage suite (benchmarks/suite.py, device time per stage),
this measures real serving wall clock — request decode, queueing, device
dispatch, the result fetch, and response encode — because the per-call
overheads are what ``--batch`` amortizes: one dispatch and one fetch per
batch instead of one per request.  Requests carry raw .npy side-by-side
frames (no image library needed).

For each requested batch size an in-process server is started, every
power-of-two batch bucket is warmed (so XLA compiles outside the timed
window), then ``--clients`` threads each fire ``--requests`` sequential
POSTs and the aggregate req/s plus per-request latency percentiles are
recorded.

Usage:
    python benchmarks/serving.py [--batches 1,8] [--clients 16]
                                 [--requests 4] [--json OUT.json]
"""

import argparse
import io
import json
import pathlib
import sys
import threading
import time
import urllib.request

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

HEIGHT, WIDTH, MAX_DISPARITY = 375, 450, 128


def _sbs_npy_body(height, width, seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    sbs = rng.integers(0, 256, (height, 2 * width), np.uint8)
    buf = io.BytesIO()
    np.save(buf, sbs)
    return buf.getvalue()


def _start_server(batch, linger_ms, extra):
    from stereomatch_tpu.cli.serve import build_parser, make_server
    argv = [str(MAX_DISPARITY), "--port", "0",
            "--batch", str(batch), "--linger-ms", str(linger_ms)] + extra
    srv = make_server(build_parser().parse_args(argv))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}/estimate?format=npy"


def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=body)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        resp.read()


def _burst(url, body, n):
    """n concurrent requests, all in flight together (joined)."""
    barrier = threading.Barrier(n)

    def client():
        barrier.wait()
        _post(url, body)

    threads = [threading.Thread(target=client) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def bench_config(batch, clients, requests, linger_ms, extra):
    srv, url = _start_server(batch, linger_ms, extra)
    body = _sbs_npy_body(HEIGHT, WIDTH)
    try:
        # Warm every power-of-two bucket the batcher can form, so no
        # compile lands inside the timed window.
        b = 1
        while b <= batch:
            _burst(url, body, b)
            b *= 2
        _burst(url, body, min(clients, max(batch, 1)))

        latencies = []
        lat_lock = threading.Lock()
        barrier = threading.Barrier(clients + 1)

        def client():
            barrier.wait()
            for _ in range(requests):
                t0 = time.perf_counter()
                _post(url, body)
                dt = time.perf_counter() - t0
                with lat_lock:
                    latencies.append(dt)

        threads = [threading.Thread(target=client) for _ in range(clients)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0

        total = clients * requests
        lat_ms = np.sort(np.asarray(latencies)) * 1e3
        result = {
            "requests": total,
            "wall_s": round(wall, 3),
            "rps": round(total / wall, 2),
            "latency_p50_ms": round(float(np.percentile(lat_ms, 50)), 2),
            "latency_p95_ms": round(float(np.percentile(lat_ms, 95)), 2),
        }
        # Server-side stage split (decode/compute/encode p50s, batcher
        # padding + device/queue per-frame) — the instrumentation that
        # says WHERE the time went, not just how much there was.
        health = url.rsplit("/", 1)[0] + "/healthz"
        try:
            with urllib.request.urlopen(health, timeout=30) as resp:
                info = json.loads(resp.read())
            result["stages"] = info.get("stages")
            result["batching"] = info.get("batching")
        except Exception:                                  # noqa: BLE001
            pass
        return result
    finally:
        srv.shutdown()
        srv.server_close()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batches", default="1,8",
                        help="comma-separated --batch values to compare")
    parser.add_argument("--clients", type=int, default=16)
    parser.add_argument("--requests", type=int, default=4,
                        help="sequential requests per client")
    parser.add_argument("--lingers", default="100",
                        help="comma-separated --linger-ms values to sweep")
    parser.add_argument("--depths", default=None,
                        help="comma-separated --pipeline-depth values "
                             "(overrides --pipeline-depth when set)")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--backend", default="auto",
                        choices=("auto", "cuda", "xla"))
    parser.add_argument("--pipeline-depth", type=int, default=2,
                        help="stm-serve worker fetch/dispatch overlap "
                             "(1 = synchronous, the pre-pipelining path)")
    parser.add_argument("--dispatch-workers", type=int, default=None,
                        help="pass --dispatch-workers to the server "
                             "(each worker carries one batch through "
                             "dispatch and fetch)")
    parser.add_argument("--no-adaptive-batch", action="store_true",
                        help="pass --no-adaptive-batch to the server "
                             "(pins the configured batch)")
    parser.add_argument("--json", default=None)
    args = parser.parse_args()

    from stereomatch_tpu.utils import benchmarking
    from stereomatch_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    benchmarking.require_accelerator()
    device = benchmarking.device_record()
    depths = ([int(d) for d in args.depths.split(",")] if args.depths
              else [args.pipeline_depth])
    lingers = [float(x) for x in args.lingers.split(",")]

    results = {}
    for depth in depths:
        extra = ["--dtype", args.dtype, "--backend", args.backend,
                 "--pipeline-depth", str(depth)]
        if args.dispatch_workers is not None:
            extra += ["--dispatch-workers", str(args.dispatch_workers)]
        if args.no_adaptive_batch:
            extra.append("--no-adaptive-batch")
        for linger in lingers:
            for batch in (int(b) for b in args.batches.split(",")):
                name = f"batch{batch}"
                if len(lingers) > 1:
                    name += f"_linger{linger:g}"
                if len(depths) > 1:
                    name += f"_depth{depth}"
                print(f"# measuring {name} ...", file=sys.stderr)
                results[name] = bench_config(
                    batch, args.clients, args.requests, linger, extra)
                print(f"#   {results[name]}", file=sys.stderr)

    payload = {"device": device, "card": benchmarking.card(),
               "clients": args.clients,
               "frame": f"{HEIGHT}x{WIDTH}xD{MAX_DISPARITY}",
               "config": f"census-wta-sgm {args.dtype} "
                         f"depths={depths}",
               "results": results}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
