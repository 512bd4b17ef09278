"""stm-serve HTTP service end to end: in-process server on an ephemeral
port, stdlib urllib client, synthetic side-by-side frames."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest

from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair

D = STM_MAX_DISPARITY

_LIVE_BATCHERS = []


def _make_batcher(args):
    """Direct _Batcher for unit tests, auto-closed after each test —
    leaked worker daemons across the suite were implicated in a
    native-level crash (round 5)."""
    from stereomatch_tpu.cli.serve import _Batcher
    b = _Batcher(args)
    _LIVE_BATCHERS.append(b)
    return b


@pytest.fixture(autouse=True)
def _close_direct_batchers():
    yield
    while _LIVE_BATCHERS:
        try:
            _LIVE_BATCHERS.pop().close()
        except Exception:
            pass


@pytest.fixture(scope="module")
def server():
    from stereomatch_tpu.cli.serve import build_parser, make_server
    args = build_parser().parse_args(
        [str(D), "--port", "0", "--backend", "xla"])
    srv = make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()


def _sbs_png():
    from PIL import Image
    left, right, gt = synthetic_stereo_pair(32, 48, D, seed=3)
    sbs = np.concatenate([(left * 255).astype(np.uint8),
                          (right * 255).astype(np.uint8)], axis=1)
    buf = io.BytesIO()
    Image.fromarray(sbs).save(buf, "PNG")
    return buf.getvalue(), left, right, gt


def test_healthz(server):
    with urllib.request.urlopen(f"{server}/healthz") as resp:
        info = json.loads(resp.read())
    assert info["status"] == "ok"
    assert info["max_disparity"] == D
    assert info["config"] == "census-wta-sgm"


def test_healthz_latency_window(server):
    body, *_ = _sbs_png()
    req = urllib.request.Request(f"{server}/estimate?format=npy", data=body)
    with urllib.request.urlopen(req) as resp:
        resp.read()
    with urllib.request.urlopen(f"{server}/healthz") as resp:
        info = json.loads(resp.read())
    assert info["latency"]["window"] >= 1
    assert info["latency"]["p50_ms"] > 0
    assert info["latency"]["p95_ms"] >= info["latency"]["p50_ms"]


def test_estimate_npy_matches_local_pipeline(server):
    from stereomatch_tpu.cli_common import create_pipeline
    body, left, right, _ = _sbs_png()
    req = urllib.request.Request(f"{server}/estimate?format=npy", data=body)
    with urllib.request.urlopen(req) as resp:
        disp = np.load(io.BytesIO(resp.read()))
    # The server decodes the PNG to uint8 grayscale; match the same
    # truncation the fixture used when writing it.
    l8 = (left * 255).astype(np.uint8).astype(np.float32)
    r8 = (right * 255).astype(np.uint8).astype(np.float32)
    pipe = create_pipeline("census", "wta", "sgm", max_disparity=D,
                           backend="xla")
    np.testing.assert_array_equal(disp, np.asarray(pipe.estimate(l8, r8)))


def test_estimate_png16_and_refine(server):
    from PIL import Image
    body, _, _, _ = _sbs_png()
    req = urllib.request.Request(f"{server}/estimate?format=png16&refine=1",
                                 data=body)
    with urllib.request.urlopen(req) as resp:
        assert resp.headers["Content-Type"] == "image/png"
        img = Image.open(io.BytesIO(resp.read()))
    arr = np.asarray(img)
    assert arr.shape == (32, 48)
    assert arr.max() < D


def test_estimate_npy_input_body(server):
    """Raw .npy [H, 2W] bodies skip image decode and give the same
    answer as the PNG path for the same 8-bit values."""
    png_body, left, right, _ = _sbs_png()
    sbs = np.concatenate([(left * 255).astype(np.uint8),
                          (right * 255).astype(np.uint8)], axis=1)
    buf = io.BytesIO()
    np.save(buf, sbs)
    req = urllib.request.Request(f"{server}/estimate?format=npy",
                                 data=buf.getvalue())
    with urllib.request.urlopen(req) as resp:
        via_npy = np.load(io.BytesIO(resp.read()))
    req = urllib.request.Request(f"{server}/estimate?format=npy",
                                 data=png_body)
    with urllib.request.urlopen(req) as resp:
        via_png = np.load(io.BytesIO(resp.read()))
    np.testing.assert_array_equal(via_npy, via_png)


def test_estimate_rejects_bad_npy_shape(server):
    buf = io.BytesIO()
    np.save(buf, np.zeros((2, 3, 4), np.uint8))
    req = urllib.request.Request(f"{server}/estimate", data=buf.getvalue())
    try:
        urllib.request.urlopen(req)
        assert False, "expected HTTP 400"
    except urllib.error.HTTPError as err:
        assert err.code == 400


def test_estimate_speckle_matches_local_filter(server):
    from stereomatch_tpu.cli_common import create_pipeline
    from stereomatch_tpu.ops.refine import filter_speckles
    body, left, right, _ = _sbs_png()
    req = urllib.request.Request(
        f"{server}/estimate?format=npy&speckle=1", data=body)
    with urllib.request.urlopen(req) as resp:
        disp = np.load(io.BytesIO(resp.read()))
    l8 = (left * 255).astype(np.uint8).astype(np.float32)
    r8 = (right * 255).astype(np.uint8).astype(np.float32)
    pipe = create_pipeline("census", "wta", "sgm", max_disparity=D,
                           backend="xla")
    raw = np.asarray(pipe.estimate(l8, r8)).astype(np.float32)
    expected = np.asarray(filter_speckles(raw, fill="background"))
    np.testing.assert_array_equal(disp, expected)


def test_estimate_rejects_garbage(server):
    req = urllib.request.Request(f"{server}/estimate", data=b"not a png")
    try:
        urllib.request.urlopen(req)
        assert False, "expected HTTP 400"
    except urllib.error.HTTPError as err:
        assert err.code == 400
        assert "error" in json.loads(err.read())


def test_sigterm_clean_exit(tmp_path):
    """SIGTERM must exit 0 after closing the socket (container stop)."""
    import signal
    import subprocess
    import sys as _sys
    import time

    proc = subprocess.Popen(
        [_sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms', 'cpu');"
         "from stereomatch_tpu.cli.serve import main;"
         f"main(['{D}', '--port', '0', '--backend', 'xla'])"],
        stderr=subprocess.PIPE, text=True)
    # Wait for the listening banner so the server loop is running.
    line = proc.stderr.readline()
    assert "listening" in line, line
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 0


def test_unknown_path_404(server):
    try:
        urllib.request.urlopen(f"{server}/nope")
        assert False, "expected HTTP 404"
    except urllib.error.HTTPError as err:
        assert err.code == 404


@pytest.fixture(scope="module")
def batch_server():
    from stereomatch_tpu.cli.serve import build_parser, make_server
    args = build_parser().parse_args(
        [str(D), "--port", "0", "--backend", "xla",
         "--batch", "4", "--linger-ms", "500"])
    srv = make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()


def test_batched_concurrent_requests_match_unbatched(batch_server):
    """6 concurrent clients through the micro-batcher: every response must
    bit-match the unbatched pipeline, and the coalescer must have formed
    at least one multi-frame batch (clients fire together, linger 500 ms)."""
    from stereomatch_tpu.cli_common import create_pipeline
    body, left, right, _ = _sbs_png()
    l8 = (left * 255).astype(np.uint8).astype(np.float32)
    r8 = (right * 255).astype(np.uint8).astype(np.float32)
    pipe = create_pipeline("census", "wta", "sgm", max_disparity=D,
                           backend="xla")
    expected = np.asarray(pipe.estimate(l8, r8))

    n = 6
    results = [None] * n
    barrier = threading.Barrier(n)

    def client(i):
        barrier.wait()
        req = urllib.request.Request(f"{batch_server}/estimate?format=npy",
                                     data=body)
        with urllib.request.urlopen(req, timeout=120) as resp:
            results[i] = np.load(io.BytesIO(resp.read()))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i in range(n):
        assert results[i] is not None, f"client {i} got no response"
        np.testing.assert_array_equal(results[i], expected)

    with urllib.request.urlopen(f"{batch_server}/healthz") as resp:
        info = json.loads(resp.read())
    assert info["frames_served"] >= n
    stats = info["batching"]
    assert stats["max_batch"] == 4
    assert stats["batched_frames"] >= n
    assert stats["batches"] < stats["batched_frames"], \
        "expected at least one coalesced multi-frame batch"


def test_batched_speckle_in_graph_matches_host_filter(batch_server):
    """speckle=1 through the batcher runs in-graph (one device call);
    must equal the host-side filter the unbatched path applies."""
    from stereomatch_tpu.cli_common import create_pipeline
    from stereomatch_tpu.ops.refine import filter_speckles
    body, left, right, _ = _sbs_png()
    req = urllib.request.Request(
        f"{batch_server}/estimate?format=npy&speckle=1", data=body)
    with urllib.request.urlopen(req, timeout=120) as resp:
        disp = np.load(io.BytesIO(resp.read()))
    l8 = (left * 255).astype(np.uint8).astype(np.float32)
    r8 = (right * 255).astype(np.uint8).astype(np.float32)
    pipe = create_pipeline("census", "wta", "sgm", max_disparity=D,
                           backend="xla")
    raw = np.asarray(pipe.estimate(l8, r8)).astype(np.float32)
    np.testing.assert_array_equal(
        disp, np.asarray(filter_speckles(raw, fill="background")))


def test_batcher_warmup_compiles_all_buckets():
    from stereomatch_tpu.cli.serve import _Batcher, build_parser
    args = build_parser().parse_args(
        [str(D), "--backend", "xla", "--batch", "4", "--linger-ms", "0"])
    batcher = _make_batcher(args)
    z = np.zeros((16, 32), np.float32)
    batcher.warmup(z, z)
    assert batcher.batches == 0 and batcher.batched_frames == 0
    assert set(batcher._fns) == {(False, False)}
    # a real request afterwards still works and counts
    out = batcher.estimate(z, z, refine=False)
    assert np.asarray(out).shape == z.shape
    assert batcher.batched_frames == 1


def test_batcher_request_timeout():
    """A hung device worker must fail the request, not block forever."""
    from stereomatch_tpu.cli.serve import _Batcher, build_parser
    args = build_parser().parse_args(
        [str(D), "--backend", "xla", "--batch", "2",
         "--request-timeout-s", "0.2", "--linger-ms", "0"])
    batcher = _make_batcher(args)

    # Stall the worker with a job whose _fn blocks.
    import time as _time
    blocker = threading.Event()

    def hang(job):
        blocker.wait(10)
        raise RuntimeError("unblocked")

    batcher._fn = hang
    left = np.zeros((8, 12), np.float32)
    t0 = _time.monotonic()
    with pytest.raises(RuntimeError, match="did not complete"):
        batcher.estimate(left, left, refine=False)
    assert _time.monotonic() - t0 < 5
    blocker.set()


def test_batcher_pyramid_mode_matches_pyramid_pipeline():
    from stereomatch_tpu.cli.serve import _Batcher, build_parser
    from stereomatch_tpu.pyramid import PyramidPipeline
    args = build_parser().parse_args(
        [str(D), "--backend", "xla", "--batch", "2", "--pyramid", "2",
         "--linger-ms", "0"])
    batcher = _make_batcher(args)
    left, right, _ = synthetic_stereo_pair(32, 48, D, seed=5)
    out = batcher.estimate(left.astype(np.float32),
                           right.astype(np.float32), refine=False)
    pyr = PyramidPipeline(D, levels=2, backend="xla")
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(pyr.estimate(left, right)))


def test_batcher_mixed_keys_all_served():
    """Interleaved geometries and refine flags exercise the parked-job
    path: every request must still get the correct-geometry answer."""
    from stereomatch_tpu.cli.serve import _Batcher, build_parser
    args = build_parser().parse_args(
        [str(D), "--backend", "xla", "--batch", "4", "--linger-ms", "50"])
    batcher = _make_batcher(args)
    shapes = [(24, 40), (32, 48)]
    jobs = []
    for i in range(8):
        h, w = shapes[i % 2]
        left, right, _ = synthetic_stereo_pair(h, w, D, seed=i)
        jobs.append((left.astype(np.float32), right.astype(np.float32),
                     i % 4 == 3))

    results = [None] * len(jobs)

    def client(i):
        left, right, refine = jobs[i]
        results[i] = np.asarray(batcher.estimate(left, right, refine))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)

    from stereomatch_tpu.cli_common import create_pipeline
    pipe = create_pipeline("census", "wta", "sgm", max_disparity=D,
                           backend="xla")
    for i, (left, right, refine) in enumerate(jobs):
        assert results[i] is not None, f"job {i} unserved"
        expected = (pipe.estimate_refined(left, right) if refine
                    else pipe.estimate(left, right))
        np.testing.assert_array_equal(results[i], np.asarray(expected))
        assert results[i].shape == left.shape


def test_batcher_mesh_mode_matches_single_chip():
    """--mesh routes requests through the sharded mesh program (rows over
    the tile axis, frames over the batch axis); exact-mode SGM keeps the
    result bit-identical to the single-chip pipeline, including the
    padding a lone request needs to fill the mesh batch axis."""
    from stereomatch_tpu.cli.serve import _Batcher, build_parser
    from stereomatch_tpu.cli_common import create_pipeline
    args = build_parser().parse_args(
        [str(D), "--backend", "xla", "--batch", "4", "--mesh",
         "--linger-ms", "50"])
    batcher = _make_batcher(args)
    left, right, _ = synthetic_stereo_pair(32, 48, D, seed=7)
    left, right = left.astype(np.float32), right.astype(np.float32)
    out = np.asarray(batcher.estimate(left, right, refine=False))
    pipe = create_pipeline("census", "wta", "sgm", max_disparity=D,
                           backend="xla")
    np.testing.assert_array_equal(out, np.asarray(pipe.estimate(left, right)))


def test_batched_refine_matches_estimate_refined(batch_server):
    """refine=1 through the batcher == Pipeline.estimate_refined defaults
    (median + sub-pixel) — pins the stream._build_frame_fn equivalence."""
    from stereomatch_tpu.cli_common import create_pipeline
    body, left, right, _ = _sbs_png()
    l8 = (left * 255).astype(np.uint8).astype(np.float32)
    r8 = (right * 255).astype(np.uint8).astype(np.float32)
    pipe = create_pipeline("census", "wta", "sgm", max_disparity=D,
                           backend="xla")
    expected = np.asarray(pipe.estimate_refined(l8, r8))
    req = urllib.request.Request(
        f"{batch_server}/estimate?format=npy&refine=1", data=body)
    with urllib.request.urlopen(req, timeout=120) as resp:
        disp = np.load(io.BytesIO(resp.read()))
    np.testing.assert_array_equal(disp, expected)


@pytest.mark.parametrize("depth", [1, 3])
def test_batcher_pipeline_depths_match(depth):
    """--pipeline-depth 1 (synchronous worker) and > 2 (deeper in-flight
    window) both serve a stream of sequential-and-concurrent requests
    with answers identical to the local pipeline; the bounded hand-off
    must not drop, reorder, or deadlock batches."""
    from stereomatch_tpu.cli.serve import _Batcher, build_parser
    from stereomatch_tpu.cli_common import create_pipeline
    args = build_parser().parse_args(
        [str(D), "--backend", "xla", "--batch", "2", "--linger-ms", "20",
         "--pipeline-depth", str(depth)])
    batcher = _make_batcher(args)
    left, right, _ = synthetic_stereo_pair(24, 40, D, seed=5)
    left, right = left.astype(np.float32), right.astype(np.float32)
    pipe = create_pipeline("census", "wta", "sgm", max_disparity=D,
                           backend="xla")
    expected = np.asarray(pipe.estimate(left, right))

    n = 9   # odd: forces a mix of full and short batches
    results = [None] * n
    barrier = threading.Barrier(n)

    def client(i):
        barrier.wait()
        results[i] = np.asarray(batcher.estimate(left, right, refine=False))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i in range(n):
        assert results[i] is not None, f"request {i} unserved"
        np.testing.assert_array_equal(results[i], expected)
    assert batcher.batched_frames == n


def test_batcher_pipelined_dispatch_error_fans_out():
    """An exception raised at dispatch time (before the device program
    runs) must fail every request of that batch, not hang the worker —
    and the worker must keep serving afterwards."""
    from stereomatch_tpu.cli.serve import _Batcher, build_parser
    args = build_parser().parse_args(
        [str(D), "--backend", "xla", "--batch", "2", "--linger-ms", "10"])
    batcher = _make_batcher(args)
    left, right, _ = synthetic_stereo_pair(24, 40, D, seed=6)
    left, right = left.astype(np.float32), right.astype(np.float32)

    boom = RuntimeError("dispatch boom")
    real_fn = batcher._fn
    batcher._fn = lambda job: (_ for _ in ()).throw(boom)
    with pytest.raises(RuntimeError, match="dispatch boom"):
        batcher.estimate(left, right, refine=False)

    batcher._fn = real_fn
    out = np.asarray(batcher.estimate(left, right, refine=False))
    assert out.shape == left.shape


def test_batcher_coalesces_backlog_past_linger():
    """Requests that piled up while a previous batch computed must still
    coalesce even though the new leader's linger window has already
    expired (linger 0 here) — the overload regime batching exists for."""
    from stereomatch_tpu.cli.serve import _Batcher, build_parser
    args = build_parser().parse_args(
        [str(D), "--backend", "xla", "--batch", "4", "--linger-ms", "0"])
    batcher = _make_batcher(args)
    left, right, _ = synthetic_stereo_pair(24, 40, D, seed=8)
    left, right = left.astype(np.float32), right.astype(np.float32)

    n = 8
    results = [None] * n
    barrier = threading.Barrier(n)

    def client(i):
        barrier.wait()
        results[i] = np.asarray(batcher.estimate(left, right, refine=False))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(r is not None for r in results)
    assert batcher.batched_frames == n
    # The first request may run alone, but everything enqueued during
    # its (slow, compiling) batch must coalesce afterwards.
    assert batcher.batches < n, \
        "zero-linger backlog was served one request per batch"


def test_warmup_compiles_every_flag_combo():
    """--warmup must pre-compile all four (refine, speckle) programs —
    a live request must never be the first to compile one."""
    from stereomatch_tpu.cli.serve import build_parser, make_server
    args = build_parser().parse_args(
        [str(D), "--port", "0", "--backend", "xla", "--batch", "2",
         "--warmup", "24x40"])
    srv = make_server(args)
    try:
        fns = srv.stm_state.batcher._fns
        assert set(fns) == {(False, False), (False, True),
                            (True, False), (True, True)}
    finally:
        srv.server_close()


def test_mesh_pyramid_rejects_indivisible_frames():
    """--mesh --pyramid: a frame whose sides don't divide by 2**levels
    must fail as a clean 400 client error, not an XLA reshape 500."""
    from stereomatch_tpu.cli.serve import build_parser, make_server
    args = build_parser().parse_args(
        [str(D), "--port", "0", "--backend", "xla", "--batch", "2",
         "--mesh", "--pyramid", "2", "--linger-ms", "0"])
    srv = make_server(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        from PIL import Image
        sbs = np.zeros((30, 68), np.uint8)     # 30 % 4 != 0, 34 % 4 != 0
        buf = io.BytesIO()
        Image.fromarray(sbs).save(buf, "PNG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_port}/estimate?format=npy",
            data=buf.getvalue())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=120)
        assert err.value.code == 400
        assert "divisible" in json.loads(err.value.read())["error"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_cvf_batched_matches_local_pipeline():
    """-am cvf behind the HTTP face, with request micro-batching: the
    batched lax.map program must reproduce the local cvf pipeline
    (narrowed to uint8 for the fetch — lossless for D <= 256)."""
    from stereomatch_tpu.cli.serve import build_parser, make_server
    from stereomatch_tpu.cli_common import create_pipeline
    args = build_parser().parse_args(
        [str(D), "--port", "0", "--backend", "xla",
         "-cm", "census", "-am", "cvf", "--cvf-radius", "3", "--batch", "2"])
    srv = make_server(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        body, left, right, _ = _sbs_png()
        url = f"http://127.0.0.1:{srv.server_port}/estimate?format=npy"
        with urllib.request.urlopen(
                urllib.request.Request(url, data=body)) as resp:
            disp = np.load(io.BytesIO(resp.read()))
        l8 = (left * 255).astype(np.uint8).astype(np.float32)
        r8 = (right * 255).astype(np.uint8).astype(np.float32)
        pipe = create_pipeline("census", "wta", "cvf", max_disparity=D,
                               cvf_radius=3, backend="xla")
        np.testing.assert_array_equal(disp.astype(np.int32),
                                      np.asarray(pipe.estimate(l8, r8)))
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_wmf_matches_local_filter():
    """A --wmf server's response equals the local pipeline + WMF chain
    (server-level flag: every request gets the edge-preserving median)."""
    from stereomatch_tpu.cli.serve import build_parser, make_server
    args = build_parser().parse_args(
        [str(D), "--port", "0", "--backend", "xla", "--wmf",
         "--wmf-sigma", "25"])
    srv = make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_port}"
        body, left, right, _ = _sbs_png()
        req = urllib.request.Request(f"{base}/estimate?format=npy",
                                     data=body)
        with urllib.request.urlopen(req) as resp:
            got = np.load(io.BytesIO(resp.read()))

        from stereomatch_tpu.cli_common import create_pipeline
        from stereomatch_tpu.ops.refine import weighted_median_filter
        pipe = create_pipeline("census", "wta", "sgm", max_disparity=D)
        l8 = np.asarray((left * 255).astype(np.uint8), np.float32)
        r8 = np.asarray((right * 255).astype(np.uint8), np.float32)
        want = np.asarray(weighted_median_filter(
            pipe.estimate(l8, r8), l8, sigma=25.0, n_bins=D))
        np.testing.assert_array_equal(got.astype(np.int32), want)
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_wmf_rejects_pyramid():
    from stereomatch_tpu.cli.serve import main
    assert main([str(D), "--wmf", "--pyramid", "1"]) == 2


def test_serve_lr_check_matches_local_pipeline():
    from stereomatch_tpu.cli.serve import build_parser, make_server
    args = build_parser().parse_args(
        [str(D), "--port", "0", "--backend", "xla", "--lr-check"])
    srv = make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_port}"
        body, left, right, _ = _sbs_png()
        req = urllib.request.Request(f"{base}/estimate?format=npy",
                                     data=body)
        with urllib.request.urlopen(req) as resp:
            got = np.load(io.BytesIO(resp.read()))

        from stereomatch_tpu.cli_common import create_pipeline
        pipe = create_pipeline("census", "wta", "sgm", max_disparity=D)
        l8 = np.asarray((left * 255).astype(np.uint8), np.float32)
        r8 = np.asarray((right * 255).astype(np.uint8), np.float32)
        want = np.asarray(pipe.estimate_refined(
            l8, r8, subpixel=False, median=False, lr_check=True,
            lr_mode="volume"))
        np.testing.assert_array_equal(got.astype(np.float32), want)
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_fgs_matches_local_pipeline():
    from stereomatch_tpu.cli.serve import build_parser, make_server
    args = build_parser().parse_args(
        [str(D), "--port", "0", "--backend", "xla", "--lr-check",
         "--fgs", "64", "--fgs-sigma", "25"])
    srv = make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_port}"
        body, left, right, _ = _sbs_png()
        req = urllib.request.Request(f"{base}/estimate?format=npy",
                                     data=body)
        with urllib.request.urlopen(req) as resp:
            got = np.load(io.BytesIO(resp.read()))

        from stereomatch_tpu.cli_common import create_pipeline
        pipe = create_pipeline("census", "wta", "sgm", max_disparity=D)
        l8 = np.asarray((left * 255).astype(np.uint8), np.float32)
        r8 = np.asarray((right * 255).astype(np.uint8), np.float32)
        want = np.asarray(pipe.estimate_refined(
            l8, r8, subpixel=False, median=False, lr_check=True,
            lr_mode="volume", fgs_lambda=64.0, fgs_sigma=25.0))
        np.testing.assert_allclose(got.astype(np.float32), want, atol=1e-2)
    finally:
        srv.shutdown()
        srv.server_close()


def test_adaptive_batch_degrades_and_restores():
    """_Batcher._adapt halves the effective cap when rolling queue time
    per frame exceeds 2x device time (8-batch hysteresis) and restores
    it as the queue drains (round 4 — the r03 batch-2/linger-0 cliff
    killer).  Unit-level: drive the EMAs directly."""
    from stereomatch_tpu.cli.serve import build_parser, _Batcher

    args = build_parser().parse_args(
        ["32", "--port", "0", "--batch", "8", "--backend", "xla"])
    b = _Batcher.__new__(_Batcher)        # no worker threads
    b.args = args
    b.max_batch = 8
    b.eff_batch = 8
    b.adaptive = True
    b._q_ema = None
    b._d_ema = None
    b._adapt_n = 0
    b._stats_lock = threading.Lock()

    # Queue >> device: two rounds of 8 batches -> cap halves twice.
    for _ in range(16):
        b._adapt(4, batch_queue_s=4.0, batch_device_s=0.4)
    assert b.eff_batch == 2

    # Queue drains: cap restores toward the configured batch.
    for _ in range(32):
        b._adapt(4, batch_queue_s=0.01, batch_device_s=0.4)
    assert b.eff_batch == 8

    # Disabled: nothing moves.
    b.adaptive = False
    b._adapt_n = 0
    for _ in range(16):
        b._adapt(4, batch_queue_s=9.0, batch_device_s=0.1)
    assert b.eff_batch == 8


def test_adaptive_batch_restore_clamps_non_pow2_cap():
    """A non-power-of-two --batch (6) degrades 6 -> 3 -> 1; the restore
    path must double back up to EXACTLY the configured cap, never past
    it (unclamped doubling would reach 8 > 6)."""
    from stereomatch_tpu.cli.serve import build_parser, _Batcher

    args = build_parser().parse_args(
        ["32", "--port", "0", "--batch", "6", "--backend", "xla"])
    b = _Batcher.__new__(_Batcher)        # no worker threads
    b.args = args
    b.max_batch = 6
    b.eff_batch = 6
    b.adaptive = True
    b._q_ema = None
    b._d_ema = None
    b._adapt_n = 0
    b._stats_lock = threading.Lock()

    for _ in range(24):
        b._adapt(4, batch_queue_s=4.0, batch_device_s=0.4)
    assert b.eff_batch == 1

    seen = [b.eff_batch]
    for _ in range(40):
        b._adapt(4, batch_queue_s=0.01, batch_device_s=0.4)
        seen.append(b.eff_batch)
    assert b.eff_batch == 6
    assert max(seen) == 6, f"cap overshot the configured batch: {seen}"


def test_dtype_auto_resolves_from_warmup_geometry():
    """--dtype auto is float32 at every geometry, for SGM and CVF alike,
    with or without --warmup: bf16 stays an explicit opt-in."""
    from stereomatch_tpu.cli.serve import build_parser, make_server

    for extra in (["--warmup", "16x24"], ["-am", "cvf", "--warmup", "16x24"],
                  []):
        args = build_parser().parse_args(
            ["16", "--port", "0", "--backend", "xla", "--dtype", "auto"]
            + extra)
        srv = make_server(args)
        try:
            assert srv.stm_state.args.dtype == "float32"
        finally:
            srv.server_close()
