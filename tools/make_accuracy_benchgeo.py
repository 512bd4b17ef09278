#!/usr/bin/env python
"""Generate benchmarks/accuracy_benchgeo_r5.json: the accuracy table at
the BENCHMARK geometries.

The small accuracy tables live at 96x128/D=32 while the benchmarks run
at teddy 450x375/D=128 or HD.  This runs the textured+occluded synthetic
scenes through stm-eval at:

* teddy geometry (375x450, D=128): flat configs + CVF/WMF/FGS +
  pyramid1/pyramid2 — the table docs/performance.md quotes next to the
  teddy perf numbers;
* an HD-scale row (1024x1280, D=256): flat census+SGM vs pyramid2 —
  the accuracy price of the only <25 ms HD config (#8).

Claims asserted at regeneration (the make_textured_eval.py discipline):
every full pipeline recovers the scene (bad-pixel sane), CVF stays
within striking distance of SGM at teddy geometry, and the pyramid
deltas are recorded, not implied.

Usage: python tools/make_accuracy_benchgeo.py [--out ...] [--device cpu]
       [--skip-hd]
"""

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent

TEDDY_CONFIGS = ("census:wta,census:wta:sgm,census:wta:cvf,ssd:wta:cvf,"
                 "census:wta:sgm+wmf,census:wta:sgm+fgs,"
                 "pyramid1,pyramid2")
HD_CONFIGS = "census:wta:sgm,census:wta:cvf,pyramid2"


def run_eval(size, configs, scenes, device, tmp, tag):
    out = tmp / f"{tag}.json"
    cmd = [sys.executable, "-m", "stereomatch_tpu.cli.evaluate",
           "--synthetic", str(scenes), "--synthetic-texture", "textured",
           "--synthetic-size", size,
           "--configs", configs, "--device", device,
           "--json", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=7200, cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(f"stm-eval {tag} failed:\n{proc.stderr[-3000:]}")
    return json.loads(out.read_text())


def summarize(res):
    """Per-config mean bad-pixel % and RMSE (stm-eval already averages
    over the scenes)."""
    return {row["name"]: {
        "bad_pixel_pct": round(row["bad_pixel_ratio"] * 100, 3),
        "rmse": round(row["rmse"], 4)} for row in res}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / "benchmarks"
                                         / "accuracy_benchgeo_r5.json"))
    ap.add_argument("--device", default="cpu",
                    help="jax platform for the evals (cpu keeps the "
                         "accelerator free; results are identical up to "
                         "backend lowering ulps)")
    ap.add_argument("--teddy-scenes", type=int, default=6)
    ap.add_argument("--hd-scenes", type=int, default=2)
    ap.add_argument("--skip-hd", action="store_true")
    args = ap.parse_args()

    payload = {"texture": "textured+occluded (io/synthetic.py)",
               "device": args.device}
    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        teddy = run_eval("375x450x128", TEDDY_CONFIGS, args.teddy_scenes,
                         args.device, tmp, "teddy_geo")
        payload["teddy_375x450_d128"] = summarize(teddy)
        if not args.skip_hd:
            hd = run_eval("1024x1280x256", HD_CONFIGS, args.hd_scenes,
                          args.device, tmp, "hd_geo")
            payload["hd_1024x1280_d256"] = summarize(hd)

    t = payload["teddy_375x450_d128"]
    # Regeneration-time claims (loud failure beats a stale table):
    for cfg, row in t.items():
        assert row["bad_pixel_pct"] < 25.0, (cfg, row)
    sgm = t["census-wta-sgm"]["bad_pixel_pct"]
    cvf = t["census-wta-cvf"]["bad_pixel_pct"]
    payload["claims"] = {
        "cvf_vs_sgm_teddy_geo_delta_pct": round(cvf - sgm, 3),
        "pyramid1_vs_flat_teddy_geo_delta_pct": round(
            t["pyramid1"]["bad_pixel_pct"] - sgm, 3),
        "pyramid2_vs_flat_teddy_geo_delta_pct": round(
            t["pyramid2"]["bad_pixel_pct"] - sgm, 3),
    }
    if "hd_1024x1280_d256" in payload:
        h = payload["hd_1024x1280_d256"]
        payload["claims"]["pyramid2_vs_flat_hd_delta_pct"] = round(
            h["pyramid2"]["bad_pixel_pct"]
            - h["census-wta-sgm"]["bad_pixel_pct"], 3)
        payload["claims"]["cvf_vs_sgm_hd_delta_pct"] = round(
            h["census-wta-cvf"]["bad_pixel_pct"]
            - h["census-wta-sgm"]["bad_pixel_pct"], 3)

    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload, indent=1))


if __name__ == "__main__":
    main()
