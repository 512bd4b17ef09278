"""Multi-chip scaling-efficiency benchmark for the sharded pipeline.

Measures frames/s of the (batch, tile) mesh pipeline at increasing device
counts on whatever devices the process can see, reporting per-device
throughput and scaling efficiency vs the single-device run.  With
several hosts, launch one process per host with ``--distributed``.
``--force-cpu`` validates the mesh logic on an 8-device virtual CPU mesh
(its result names the CPU as the device).  ``--model`` prints the
interconnect model's table at the published rates of this machine's
device (utils/devices.py), each replaced by ``--link-gbps``/``--hbm-gbps``
where given (with both, no device is needed).

Usage:
    python benchmarks/scaling.py [--force-cpu] [--distributed]
        [--height 384] [--width 448] [--disp 128] [--frames-per-chip 2]
        [--sgm-mode overlap|exact]
"""

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def measure(mesh, args):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from stereomatch_tpu.parallel import make_sharded_estimate
    from stereomatch_tpu.parallel.mesh import BATCH_AXIS, TILE_AXIS

    n_batch = mesh.shape[BATCH_AXIS]
    n_tile = mesh.shape[TILE_AXIS]
    n_dev = n_batch * n_tile

    height = args.height - (args.height % n_tile)
    batch = args.frames_per_chip * n_batch
    fn = make_sharded_estimate(
        mesh, max_disparity=args.disp, aggregation="sgm", reducer="wta",
        sgm_mode=args.sgm_mode, overlap=args.overlap,
        backend="xla" if args.force_cpu else "auto")

    rng = np.random.default_rng(0)
    left = rng.random((batch, height, args.width), np.float32)
    right = rng.random((batch, height, args.width), np.float32)
    # Globally-sharded inputs: required under multi-process execution,
    # harmless (and copy-free per shard) single-process.
    sharding = NamedSharding(mesh, P(BATCH_AXIS, TILE_AXIS, None))
    gleft = jax.make_array_from_callback(left.shape, sharding,
                                         lambda idx: left[idx])
    gright = jax.make_array_from_callback(right.shape, sharding,
                                          lambda idx: right[idx])

    jax.block_until_ready(fn(gleft, gright))     # compile
    reps = max(args.reps, 1)
    best = float("inf")
    for _ in range(reps):
        start = time.perf_counter()
        jax.block_until_ready(fn(gleft, gright))
        best = min(best, time.perf_counter() - start)
    fps = batch / best
    return {"devices": n_dev, "mesh": dict(mesh.shape), "batch": batch,
            "image": [height, args.width], "fps": round(fps, 2),
            "fps_per_chip": round(fps / n_dev, 2)}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--force-cpu", action="store_true",
                        help="8-device virtual CPU mesh (logic validation).")
    parser.add_argument("--distributed", action="store_true",
                        help="Multi-host: call jax.distributed.initialize.")
    parser.add_argument("--coordinator", default=None,
                        help="coordinator host:port for --distributed "
                             "(default: cluster auto-detection).")
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--height", type=int, default=384)
    parser.add_argument("--width", type=int, default=448)
    parser.add_argument("--disp", type=int, default=128)
    parser.add_argument("--frames-per-chip", type=int, default=2)
    parser.add_argument("--sgm-mode", default="overlap",
                        choices=["overlap", "exact"])
    parser.add_argument("--overlap", type=int, default=48)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--json", default=None)
    parser.add_argument("--model", action="store_true",
                        help="emit the analytic interconnect traffic "
                             "model table and exit")
    parser.add_argument("--model-tiles", type=int, default=4)
    parser.add_argument("--link-gbps", type=float, default=None)
    parser.add_argument("--hbm-gbps", type=float, default=None)
    args = parser.parse_args()

    if args.model:
        from stereomatch_tpu.parallel.ici_model import ici_traffic_model
        link, hbm = args.link_gbps, args.hbm_gbps
        if link is None or hbm is None:
            from stereomatch_tpu.utils.devices import device_spec
            spec = device_spec()
            link = spec.link_bytes_per_s / 1e9 if link is None else link
            hbm = spec.hbm_bytes_per_s / 1e9 if hbm is None else hbm
        rows = ici_traffic_model(height=args.height, width=args.width,
                                 disp=args.disp, tiles=args.model_tiles,
                                 overlap=args.overlap, link_gbps=link,
                                 hbm_gbps=hbm)
        for r in rows:
            print(f"{r['config']:20s} "
                  f"link={r['link_bytes_per_frame']/1e6:8.2f} MB/frame "
                  f"({r['link_vs_volume']:.3f} vol) "
                  f"stages={r['serial_stages']:3d} "
                  f"eff={r['predicted_efficiency']:.3f}  {r['note']}",
                  file=sys.stderr)
        payload = {"model": True,
                   "params": {"height": args.height, "width": args.width,
                              "disp": args.disp, "tiles": args.model_tiles,
                              "link_gbps": link, "hbm_gbps": hbm},
                   "rows": rows}
        if args.json:
            with open(args.json, "w") as f:
                json.dump(payload, f, indent=2)
        print(json.dumps(payload))
        return

    import os
    if args.force_cpu and ("--xla_force_host_platform_device_count"
                           not in os.environ.get("XLA_FLAGS", "")):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
    import jax
    if args.force_cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.distributed:
        # Directly (not via stereomatch_tpu.parallel): importing the
        # package initializes the XLA backend, after which distributed
        # init is rejected.
        kwargs = {}
        if args.coordinator:
            kwargs = dict(coordinator_address=args.coordinator,
                          process_id=args.process_id,
                          num_processes=args.num_processes)
        jax.distributed.initialize(**kwargs)

    from stereomatch_tpu.parallel import make_mesh
    from stereomatch_tpu.parallel.mesh import make_hybrid_mesh

    devices = jax.devices()
    if devices[0].platform == "cpu" and not args.force_cpu:
        sys.exit("scaling: no accelerator (pass --force-cpu for the CPU "
                 "logic check)")
    rows = []
    if jax.process_count() > 1:
        # Multi-process SPMD: every process must join every computation,
        # so measure only the full hybrid mesh (frames over hosts, rows
        # in-host).
        rows.append(measure(make_hybrid_mesh(), args))
    else:
        n = 1
        while n <= len(devices):
            mesh = make_mesh(devices[:n])
            rows.append(measure(mesh, args))
            n *= 2
    base = rows[0]["fps_per_chip"]
    for row in rows:
        row["scaling_efficiency"] = round(row["fps_per_chip"] / base, 3)
        print(f"devices={row['devices']:3d} mesh={row['mesh']} "
              f"fps={row['fps']:9.2f} /chip={row['fps_per_chip']:8.2f} "
              f"eff={row['scaling_efficiency']:.2f}", file=sys.stderr)

    from stereomatch_tpu.utils.benchmarking import card
    payload = {"device_kind": devices[0].device_kind,
               "platform": devices[0].platform, "count": len(devices),
               "card": card(), "rows": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
