"""Generate the production-geometry golden anchor
(tests/data/golden_teddy_disparity.npz).

Teddy geometry — 450x375, D=128, k=7 (the reference's full-resolution
fixture scale, /root/reference/tests/conftest.py:58-78) — on the fixed
synthetic scene, computed by the XLA scan formulations (the semantic
oracles).  tests/test_golden_teddy.py pins every execution path (XLA,
the SGM kernel's model, bf16, sharded-exact) to these arrays at the bit
level across rounds, and tests/test_gpu_hardware.py pins the Hopper
kernel on the card.  A 448-wide crop of the scene carries its own stored
array.

Run from the repo root (CPU is forced; ~30 s):
    python tools/make_golden_teddy.py
"""

import os
import pathlib
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HEIGHT, WIDTH, MAX_DISP = 375, 450, 128
WGRID_WIDTH = 448
SEED, KERNEL, P1, P2 = 2026, 7, 0.1, 0.2
OUT = (pathlib.Path(__file__).resolve().parent.parent
       / "tests" / "data" / "golden_teddy_disparity.npz")


def main():
    from stereomatch_tpu.io.synthetic import stereo_pair
    from stereomatch_tpu.ops.aggregation import semiglobal_aggregate
    from stereomatch_tpu.ops.cost import ssd_cost_volume
    from stereomatch_tpu.ops.disparity import (dynamic_programming,
                                               winner_takes_all)

    left, right, gt = stereo_pair(HEIGHT, WIDTH, MAX_DISP, SEED)

    vol = ssd_cost_volume(left, right, max_disparity=MAX_DISP,
                          kernel_size=KERNEL)
    agg = semiglobal_aggregate(vol, left, penalty1=P1, penalty2=P2)
    wta = np.asarray(winner_takes_all(agg))
    dp = np.asarray(dynamic_programming(agg))
    bad = float(np.mean((np.abs(wta - gt) > 1)[:, MAX_DISP:]))
    print(f"f32: bad-pixel vs exact GT = {bad:.4%}")
    assert bad < 0.06, "refusing to commit a golden from a broken build"

    # bf16 storage path (same oracle, bf16 volume): its WTA is pinned as
    # its own array — whether it coincides with f32 is recorded, not
    # assumed.
    vol16 = ssd_cost_volume(left, right, max_disparity=MAX_DISP,
                            kernel_size=KERNEL, cost_dtype=jnp.bfloat16)
    agg16 = semiglobal_aggregate(vol16, left, penalty1=P1, penalty2=P2)
    wta16 = np.asarray(winner_takes_all(agg16))
    print(f"bf16: WTA differs from f32 on {np.mean(wta16 != wta):.4%} "
          f"of pixels")

    # 448-wide leg: the same scene cropped to 448 columns.
    lc, rc = left[:, :WGRID_WIDTH], right[:, :WGRID_WIDTH]
    volc = ssd_cost_volume(lc, rc, max_disparity=MAX_DISP,
                           kernel_size=KERNEL)
    aggc = semiglobal_aggregate(volc, lc, penalty1=P1, penalty2=P2)
    wta448 = np.asarray(winner_takes_all(aggc))

    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        OUT,
        height=HEIGHT, width=WIDTH, max_disparity=MAX_DISP, seed=SEED,
        kernel_size=KERNEL, penalty1=P1, penalty2=P2,
        wta=wta, dp=dp, bad_pixel_vs_gt=bad,
        wta_bf16=wta16,
        wgrid_width=WGRID_WIDTH, wta_448=wta448,
    )
    print(f"wrote {OUT} ({OUT.stat().st_size / 1024:.0f} KiB)")


if __name__ == "__main__":
    main()
